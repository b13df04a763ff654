"""PyTorch/CUDA port of vbt_tpu for NVIDIA Hopper (H100).

A second package beside ``vbt_tpu`` (the JAX reference). It imports torch,
never jax or flax, and nothing of ``vbt_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; a CUDA request without a card
raises (:func:`vbt_tpu_torch.utils.device.resolve_device`).

Ported so far: the ``track`` path through EfficientDet-Lite with the
hand-written Hopper NMS kernel (``csrc/nms.cu``) and the host OC-SORT.
"""
