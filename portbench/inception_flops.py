"""The work of the FID InceptionV3's trunk and the card's float32 peak, whatever implements them.

The trunk's multiply-adds are counted from the reference's layer table
(:data:`portbench.references.fid_inception.CONVS`): each convolution's output pixels times its output
channels times its input channels times its kernel's taps, at the input size, for one image. Only the
94 convolutions count: pools, batch norms, the resize and the 2048-wide mean add under 0.1%.

The peak is one NVIDIA H100 SXM's float32 rate outside the tensor cores, NVIDIA's data sheet, at the
card's full 700 W (TF32 is off in the program, so the tensor cores' TF32 rate does not apply).
"""
import functools

from portbench.references import fid_inception as reference

FP32_FLOP_PER_S = 67e12


@functools.lru_cache(maxsize=None)
def trunk_macs(size: int = reference.SIZE) -> int:
    """Multiply-adds of the trunk's convolutions for one ``size x size`` image (5,711,168,096 at 299)."""
    total = 0
    for name, _, (_, cout, h, w) in reference.conv_shapes(size):
        _, cin, _, (kh, kw), _, _ = reference.TABLE[name]
        total += h * w * cout * cin * kh * kw
    return total


def least_seconds(work) -> float:
    """The least time the card could take for the trunk over the updates ``work`` (each ``images`` at
    ``size``): two operations a multiply-add at the float32 peak."""
    return sum(2.0 * trunk_macs(w["size"]) * w["images"] for w in work) / FP32_FLOP_PER_S
