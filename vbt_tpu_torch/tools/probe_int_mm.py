#!/usr/bin/env python3
"""Which int8 product shapes of a model ``torch._int_mm`` takes on one CUDA card.

    python3 vbt_tpu_torch/tools/probe_int_mm.py [--model efficientdet_lite0] [--batch 64 1]

Collects the (m, k, n) of every int8 product the model's dense convolutions
make at its input size (``quant.gemm_shape``), then runs each on the card
with random int8 operands in the layout ``quant.int8_matmul`` uses, padded
two ways: every side up to a multiple of 8 (m at least 24), the least torch
itself asks, and ``quant.int_mm_shape``, the port's rule. Prints the card's
name and power limit and, for each rule, the shapes cuBLAS refused or got
wrong (a result row checked against float64).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def product_shapes(model_name: str) -> set[tuple[int, int, int]]:
    """(m, k, n) at batch 1 of every dense conv call in one forward."""
    import torch

    from vbt_tpu_torch.models import EfficientDet, get_model_spec
    from vbt_tpu_torch.models import quant as q
    from vbt_tpu_torch.models.conv import same_pads

    spec = get_model_spec(model_name)
    model = EfficientDet(spec)
    shapes = set()

    def hook(conv, args, _out):
        _, c, h, w = args[0].shape
        pads = [sum(same_pads(s, conv.kernel, conv.stride)) for s in (h, w)]
        shapes.add(q.gemm_shape((1, c, h + pads[0], w + pads[1]), conv.weight.shape,
                                conv.stride))

    for conv in q.dense_convs(model).values():
        conv.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, spec.input_size, spec.input_size))
    return shapes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="efficientdet_lite0")
    parser.add_argument("--batch", type=int, nargs="+", default=[64, 1])
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_int_mm: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from vbt_tpu_torch.models import quant as q

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    up = lambda v, a: -(-v // a) * a  # noqa: E731
    rules = {"multiples of 8": lambda m, k, n: (max(up(m, 8), 24), up(k, 8), up(n, 8)),
             "int_mm_shape": q.int_mm_shape}
    shapes = sorted(product_shapes(args.model))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, rule in rules.items():
        bad = []
        for batch in args.batch:
            for m1, k, n in shapes:
                mp, kp, np_ = rule(m1 * batch, k, n)
                a = torch.randint(-127, 128, (mp, kp), dtype=torch.int8, device="cuda",
                                  generator=gen)
                w = torch.randint(-127, 128, (np_, kp), dtype=torch.int8, device="cuda",
                                  generator=gen)
                try:
                    row = torch._int_mm(a, w.t())[:1].double()
                except RuntimeError:
                    bad.append((m1 * batch, k, n, "refused"))
                    continue
                if not torch.equal(row, a[:1].double() @ w.double().t()):
                    bad.append((m1 * batch, k, n, "wrong"))
        print(f"{args.model}, {len(shapes)} product shapes a batch, batches {args.batch}, "
              f"padded to {name}: {len(bad)} not taken {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
