#!/usr/bin/env python
"""Convert a PyTorch InceptionV3 state dict to the flat .npz of the FID extractors.

The counterpart of ``tools/convert_inception_weights.py`` with no JAX: the
same arguments, and the same ``.npz``, byte for byte
(``metrics_tpu_torch.image.inception_net.convert_torch_state_dict``). It
takes the state-dict layout of ``torch_fidelity``'s FID InceptionV3 and of
torchvision's ``inception_v3`` (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ``fc.weight``), drops
``num_batches_tracked`` and ``AuxLogits.*``, checks every key and shape
against the port's InceptionV3 (an abort shows the full diff) and warns on
torchvision's 1,000-logit head.

Usage (no network is used; obtain the .pth elsewhere)::

    python tools/torch_convert_inception_weights.py pt_inception.pth inception.npz

The port also loads the ``.pth`` itself:
``InceptionV3FeatureExtractor(weights_path="pt_inception.pth")``.
"""
import argparse
import os
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("torch_weights", help=".pth/.pt state dict (torch.load-able)")
    parser.add_argument("out_npz", help="output .npz for InceptionV3FeatureExtractor(weights_path=...)")
    args = parser.parse_args(argv)

    from metrics_tpu_torch.image import inception_net

    state = inception_net.load_torch(args.torch_weights)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        flat = inception_net.convert_torch_state_dict(state)
    for w in caught:
        print(f"WARNING: {w.message}", file=sys.stderr)
    num_classes = flat["params/Dense_0/kernel"].shape[1]
    inception_net.save_params(args.out_npz, flat)
    print(f"wrote {args.out_npz}: {len(flat)} arrays, num_classes={num_classes}")
    print("load with: InceptionV3FeatureExtractor(weights_path=%r)" % args.out_npz)


if __name__ == "__main__":
    main()
