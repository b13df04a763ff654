"""The reference project's data, as the port's tools find it.

These stand where the JAX package's tools name the reference project's
fixed absolute location: its selection tools default ``--data_dir`` to its
``data/`` (``tools/ckpt_sweep.py:17``), its checks and ``make_demo_video``
read every JPEG of its ``data/test/`` (``tools/turbo_check.py:107``), its
figure tools read its ``dfs/``. The port's are relative to the working
directory (the repository root, where a copy of the reference project's
``data/`` and ``dfs/`` is placed under ``reference/``), so it reads
nothing outside its checkout. As in the JAX package, no environment
variable or option moves the root; the tools that take ``--data_dir`` take
it as JAX's do.
"""

import os

ROOT = "reference"
DATA_DIR = os.path.join(ROOT, "data")  # VOC splits: train/, valid/, test/
TEST_DIR = os.path.join(DATA_DIR, "test")
DFS_DIR = os.path.join(ROOT, "dfs")  # the reference project's cached dataframes
