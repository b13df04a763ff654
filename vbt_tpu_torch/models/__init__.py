"""EfficientDet-Lite in torch: backbone, BiFPN, heads, anchors, specs."""

from vbt_tpu_torch.models.efficientdet import (
    MODEL_SPECS,
    EfficientDet,
    ModelSpec,
    get_model_spec,
)

__all__ = ["MODEL_SPECS", "EfficientDet", "ModelSpec", "get_model_spec"]
