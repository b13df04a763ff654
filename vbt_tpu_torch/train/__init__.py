"""Training (losses, targets, augmentation, the train step, the device-resident
loop) and detector evaluation (COCO AP on VOC ground truth)."""
