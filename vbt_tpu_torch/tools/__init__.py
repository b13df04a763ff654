"""Operator tools of the port: checkpoint selection after ``vbt-torch-train``
(:mod:`.ckpt_sweep`, :mod:`.ckpt_soup`, :mod:`.int8_delta`), the card
probes (:mod:`.time_nms`, :mod:`.probe_int_mm`) and the host figure tools
(:mod:`.gen_eval_figs`, :mod:`.gen_docs_pngs`). Each runs as
``python -m vbt_tpu_torch.tools.<name>``; click, cv2, pandas and the
plotting packages are imported inside the functions that use them."""
