"""A throwaway checkout for the tests: ``BENCHMARK.json``, configurations, mixes and limits of the real
ones at a size the CPU runs in a second, under a temporary root."""
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = ("tiny.logits", "tiny.labels")
CLASSES = 6


def make_root(root: Path, classes: int = CLASSES, images: int = 10, height: int = 64, width: int = 128) -> Path:
    for sub in ("configs", "mixes", "limits"):
        (root / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    config = json.loads((REPO / "portbench/configs/cityscapes_val_seg.json").read_text())
    void = classes - 1
    config.update(images=images, height=height, width=width, num_classes=classes, void=void)
    for member in config["metrics"].values():
        member.update(num_classes=classes, ignore_index=void)
    (root / "portbench/configs/tiny.json").write_text(json.dumps(config))
    for name in ("eval_logits", "eval_labels"):
        mix = json.loads((REPO / f"portbench/mixes/{name}.json").read_text())
        mix["updates_per_epoch"] = 3
        (root / f"portbench/mixes/{name}.json").write_text(json.dumps(mix))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "tiny", "source": "https://example.org/tiny", "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "a test size"}]
    manifest["workloads"] = [
        {"name": CELLS[0], "config": "tiny", "traffic": "eval_logits", "chips": 1, "why": "scores"},
        {"name": CELLS[1], "config": "tiny", "traffic": "eval_labels", "chips": 1, "why": "labels"},
    ]
    for metric in manifest["per_layer"]:
        metric["workloads"] = list(CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    limits = json.loads((REPO / "portbench/limits/cityscapes_val_seg.eval_logits.json").read_text())
    for cell in CELLS:
        (root / f"portbench/limits/{cell}.json").write_text(json.dumps(limits))
    return root
