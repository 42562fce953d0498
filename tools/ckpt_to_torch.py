#!/usr/bin/env python3
"""Convert a training checkpoint of the JAX package (an orbax
directory, yolo_tpu/io/checkpoint.py) into a checkpoint of the PyTorch
port (yolo_tpu_torch/io/checkpoint.py: state.pt + meta.json).

    python3 tools/ckpt_to_torch.py JAX_CKPT_DIR OUT_DIR [--model NAME]

Runs where JAX and orbax are installed (the card machine has neither);
the output directory is what `python -m yolo_tpu_torch.cli export`,
`train --resume`, `eval --weights` and `yolo_tpu_torch.load` read. The
params, the EMA track, the optimizer's momentum (SGD) or moments (Adam),
the step and seen counters carry across (from_numpy_state).
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="orbax checkpoint directory of yolo_tpu")
    ap.add_argument("dst", help="checkpoint directory to write")
    ap.add_argument("--model", default="",
                    help="model name recorded in meta.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    from yolo_tpu.io import checkpoint as jax_checkpoint
    from yolo_tpu_torch.io import checkpoint

    state = jax.device_get(jax_checkpoint.restore(args.src))
    tree = checkpoint.from_numpy_state(state)
    checkpoint.save(args.dst, tree, model=args.model)
    print(f"wrote {args.dst}: step {tree['step']}, "
          f"{len(tree['params'])} weighted layers, keys "
          f"{sorted(tree)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
