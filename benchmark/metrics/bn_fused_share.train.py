"""The share of the program's train-mode BatchNorm calls on the card that
took the fused BatchNorm-and-activation kernels (``csrc/batchnorm_act.cu``):
``BatchNorm.train_calls["fused"]`` over ``["card"]``, %, process-wide (a
replay of the step's CUDA graph adds the calls it holds; the check runs the
reference alone, no program step)."""


def read(run):
    try:
        from vbt_tpu_torch.models.conv import BatchNorm
    except ImportError:  # a program without the module
        return None
    calls = getattr(BatchNorm, "train_calls", None)
    if not calls or not calls.get("card"):
        return None  # a program without the counter, or no call on the card
    return 100.0 * calls["fused"] / calls["card"]
