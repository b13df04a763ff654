#!/usr/bin/env python3
"""Time the NMS kernel of a checkout of this repository on one CUDA card.

    python3 vbt_tpu_torch/tools/time_nms.py [--root DIR]

``--root`` is the root of the checkout whose ``vbt_tpu_torch`` is imported
and whose ``csrc/nms.cu`` is built (default: the checkout this file is in).
To compare two commits' kernels by the same method, unpack the other commit
with ``git archive`` and run this file once per root, in turns, on the
same card: both get the same inputs, the candidates (B = 64,
K = 512) that EfficientDet-Lite0 with the shipped weights, bf16, gives for
64 synthetic 720x1280 frames of a moving plate (seed 0).

The kernel is held against ``nms_plain`` (counts exact, scores 1e-6, boxes
1e-5), then timed two ways: the replay of a CUDA graph of 100 launches (the
card's own time) and a loop of 200 eager launches (the host's share of a
launch included), each three times. Prints the card's name and power limit
and one JSON line with the times in microseconds a launch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, K, HEIGHT, WIDTH = 64, 512, 720, 1280


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_nms: this needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import gather_decode, nms_plain, top_k_candidates
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    ckpt = os.path.join(root, "models", "efficientdet_lite0_whole.msgpack")
    pipe = DetectionPipeline.from_model_arg(ckpt, device="cuda")
    deltas, logits = pipe.forward(plate_frames(BATCH, HEIGHT, WIDTH, seed=0))
    top_logits, idx = top_k_candidates(logits[..., 0].float(), K)
    boxes = gather_decode(deltas, pipe.anchors, idx, pipe.spec.input_size).contiguous()
    top_logits = top_logits.contiguous()

    got, want = nms(top_logits, boxes), nms_plain(top_logits, boxes)
    torch.cuda.synchronize()
    ds = (got[1] - want[1]).abs().max().item()
    db = (got[2] - want[2]).abs().max().item()
    if not torch.equal(got[0], want[0]) or ds > 1e-6 or db > 1e-5:
        raise AssertionError(f"nms of {root} disagrees with nms_plain: scores {ds}, boxes {db}")

    def elapsed_us(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps * 1e3

    def eager():
        for _ in range(200):
            nms(top_logits, boxes)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(100):
            nms(top_logits, boxes)
    graph.replay()
    eager()
    graph_us = [elapsed_us(graph.replay, 100) for _ in range(3)]
    eager_us = [elapsed_us(eager, 200) for _ in range(3)]
    print(json.dumps({"root": os.path.relpath(root), "card": smi,
                      "selected": int(got[0].sum().item()), "graph_us": graph_us,
                      "eager_us": eager_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
