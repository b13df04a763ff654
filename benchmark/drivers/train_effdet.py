"""The train family on the D specs (EfficientDet-D3): the cell of
``drivers/train.py`` with one change, the plain trainer that judges the
step. ``train.py``'s check imports ``PlainTrainer`` from
``reference/train/step.py`` when it runs, and that trainer builds the lite
modules of ``reference/model``; here the check runs with the D family's
(``reference/effdet/step.py``) in its place, and everything else of the
cell (traffic, set-up, window, stages, numbers) is ``train.py``'s.
"""

from __future__ import annotations

from benchmark.drivers import train


class Cell(train.Cell):
    def reference_records(self, tf32: bool = False) -> tuple[dict, dict]:
        from benchmark.reference.effdet.step import PlainTrainer
        from benchmark.reference.train import step

        lite = step.PlainTrainer
        step.PlainTrainer = PlainTrainer
        try:
            return super().reference_records(tf32)
        finally:
            step.PlainTrainer = lite
