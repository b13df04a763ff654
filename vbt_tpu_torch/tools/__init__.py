"""Operator tools of the port: checkpoint selection after ``vbt-torch-train``
(:mod:`.ckpt_sweep`, :mod:`.ckpt_soup`, :mod:`.int8_delta`), the card
probes (:mod:`.time_nms`, :mod:`.probe_int_mm`), the measurement tools
(:mod:`.roofline`, :mod:`.perf_probe`, :mod:`.int8_profile`,
:mod:`.turbo_check`, :mod:`.prefilter_check`, on the marginal method of
:mod:`._timing`, which the bench shares) and the host figure tools
(:mod:`.gen_eval_figs`, :mod:`.gen_docs_pngs`). Each runs as
``python -m vbt_tpu_torch.tools.<name>``; click, cv2, pandas and the
plotting packages are imported inside the functions that use them."""
