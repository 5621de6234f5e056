#!/usr/bin/env python
"""Convert PyTorch LPIPS weights (backbone and lin heads) to the flat .npz of LPIPSNet.

The counterpart of ``tools/convert_lpips_weights.py`` with no JAX: the same
arguments, and the same ``.npz``, byte for byte
(``metrics_tpu_torch.image.lpips_net.convert_torch_state_dict``), after
every key and shape is checked against the port's LPIPS module.

Usage (no network is used; obtain the .pth files elsewhere)::

    python tools/torch_convert_lpips_weights.py --net alex \\
        --backbone alexnet_features.pth --lins lpips_alex.pth lpips_alex.npz

``--backbone`` takes a torchvision ``alexnet().features.state_dict()`` /
``vgg16().features.state_dict()`` / ``squeezenet1_1().features.state_dict()``
file; ``--lins`` the lpips checkpoint (``lin0.model.1.weight`` ...). The port
also loads the pair itself: ``LPIPSNet(net_type="alex",
weights_path=("alexnet_features.pth", "lpips_alex.pth"))``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--net", choices=("alex", "vgg", "squeeze"), required=True)
    parser.add_argument("--backbone", required=True, help="torchvision features state dict (.pth)")
    parser.add_argument("--lins", required=True, help="lpips v0.1 checkpoint (.pth)")
    parser.add_argument("out_npz")
    args = parser.parse_args(argv)

    from metrics_tpu_torch.image import inception_net, lpips_net

    flat = lpips_net.convert_torch_state_dict(
        inception_net.load_torch(args.backbone), inception_net.load_torch(args.lins), args.net)
    inception_net.save_params(args.out_npz, flat)
    print(f"wrote {args.out_npz}: {len(flat)} arrays")
    print("load with: LPIPSNet(net_type=%r, weights_path=%r)" % (args.net, args.out_npz))


if __name__ == "__main__":
    main()
