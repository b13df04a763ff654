"""The train step's CUDA graph's private pool over the card's memory, %:
``runtime/graphs.py::pool_bytes()["train"]``, the largest pool a graph
captured under ``DeviceDataTrainer``'s name left in the process (the
step's activations and the copies it hands back; read after the program
is freed, which leaves the reading), over ``total_memory`` of card 0.
Nothing from a program without the gauge, with no train graph or with no
card."""


def read(run):
    try:
        from vbt_tpu_torch.runtime.graphs import pool_bytes
    except ImportError:  # a program without the gauge
        return None
    import torch

    got = pool_bytes().get("train")
    if not got or not torch.cuda.is_available():
        return None
    return 100.0 * got / torch.cuda.get_device_properties(0).total_memory
