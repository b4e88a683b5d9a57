"""Rewrite a training checkpoint as a quantized serving checkpoint.

Port of ``scripts/quantize_model.py``: weight-only bf16 / int8 with the same
checkpoint keys, so ``Predictor``, ``serve`` and ``evaluate`` (of this
package and of the JAX package) load the result unchanged: they see the
``"quantization"`` marker.  Works on the host; needs no GPU.

    python -m nbody_gnn_hpc_torch.quantize_model -m models/best_model.pt --mode int8
    python -m nbody_gnn_hpc_torch.serve -m models/best_model.int8.pt
"""

import argparse
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Quantize a checkpoint for serving")
    parser.add_argument("--model-path", "-m", default="models/best_model.pt")
    parser.add_argument("--output", "-o", default=None,
                        help="Destination (default: <model>.<mode>.pt)")
    parser.add_argument("--mode", choices=("bf16", "int8"), default="int8")
    args = parser.parse_args(argv)

    from nbody_gnn_hpc_torch.predict import quantize_checkpoint

    src = Path(args.model_path)
    dst = Path(args.output) if args.output else src.with_suffix(
        f".{args.mode}.pt")
    info = quantize_checkpoint(str(src), str(dst), args.mode)
    print(f"{src} ({info['src_bytes'] / 1e6:.1f} MB) -> "
          f"{dst} ({info['dst_bytes'] / 1e6:.1f} MB), "
          f"{info['ratio']}x smaller [{info['mode']}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
