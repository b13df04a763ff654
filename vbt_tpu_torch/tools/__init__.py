"""Operator tools of the port: checkpoint selection after ``vbt-torch-train``
(:mod:`.ckpt_sweep`, :mod:`.ckpt_soup`, :mod:`.int8_delta`) and the card
probes (:mod:`.time_nms`, :mod:`.probe_int_mm`). Each runs as
``python -m vbt_tpu_torch.tools.<name>``; click, cv2 and pandas are
imported inside the functions that use them."""
