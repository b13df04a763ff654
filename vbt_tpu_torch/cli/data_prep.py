"""Partition LabelStudio exports into train/test/valid directories.

Port of ``vbt_tpu.cli.data_prep``: an 85/5/10 split after a shuffle by a
numpy ``Generator``; the valid partition is the tail of the shuffled list
(so train and valid can overlap when the shares sum past 1, like the
reference's ``files[-num_valid:]``). Files are copied as jpg+xml pairs.
click is imported inside :func:`make_command`.

Usage: ``python -m vbt_tpu_torch.cli.data_prep --annotations_dir
tmp/project3/Annotations --images_dir tmp/project3/images --dest_dir data``
"""

from __future__ import annotations

import glob
import os
import shutil

import numpy as np

TRAIN_PERCENTAGE = 0.85
TEST_PERCENTAGE = 0.05
VALID_PERCENTAGE = 0.1


def split_files(files: list[str], rng: np.random.Generator) -> dict[str, list[str]]:
    files = list(files)
    rng.shuffle(files)
    num_train = round(len(files) * TRAIN_PERCENTAGE)
    num_test = round(len(files) * TEST_PERCENTAGE)
    num_valid = round(len(files) * VALID_PERCENTAGE)
    return {
        "train": files[0:num_train],
        "test": files[num_train:num_train + num_test],
        "valid": files[-num_valid:] if num_valid else [],
    }


def copy_pairs(stems, annotations_dir, images_dir, dest_dir, partition):
    os.makedirs(os.path.join(dest_dir, partition), exist_ok=True)
    for stem in stems:
        for ext, src_dir in ((".xml", annotations_dir), (".jpg", images_dir)):
            shutil.copy(os.path.join(src_dir, stem + ext),
                        os.path.join(dest_dir, partition, stem + ext))


def run(annotations_dir, images_dir, dest_dir, seed) -> dict[str, list[str]]:
    """Split and copy; returns the partitions' stems."""
    files = [os.path.basename(p)[:-4] for p in glob.glob(os.path.join(annotations_dir, "*"))]
    parts = split_files(files, np.random.default_rng(seed))
    for partition, stems in parts.items():
        copy_pairs(stems, annotations_dir, images_dir, dest_dir, partition)
        print(f"{partition}: {len(stems)} pairs")
    return parts


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    @click.command()
    @click.option("--annotations_dir", default="tmp/project3/Annotations", show_default=True)
    @click.option("--images_dir", default="tmp/project3/images", show_default=True)
    @click.option("--dest_dir", default="data", show_default=True)
    @click.option("--seed", default=None, type=int, help="Shuffle seed (reference uses none).")
    def command(annotations_dir, images_dir, dest_dir, seed):
        """Split a LabelStudio export into train/test/valid VOC directories."""
        run(annotations_dir, images_dir, dest_dir, seed)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-data-prep``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
