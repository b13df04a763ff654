"""PASCAL-VOC detection annotations, the ground truth of evaluation.

Copy of ``vbt_tpu.contract.parsers``'s VOC readers (``read_voc_file``,
``read_voc_annotations``): ``<object><name>barbell</name><bndbox>`` boxes
as ``[ymin, xmin, ymax, xmax]`` integer rows. The Kinovea and Qualisys
readers come with the ground-truth validation CLIs.
"""

from __future__ import annotations

import glob
import os
import xml.etree.ElementTree as ET

import numpy as np

DEFAULT_LABEL = "barbell"


def read_voc_file(path: str, label: str = DEFAULT_LABEL) -> tuple[str, np.ndarray]:
    """Parse one PASCAL-VOC XML file into ``(image_filename, boxes)``, boxes
    an (N, 4) int array of ``[ymin, xmin, ymax, xmax]`` rows of the objects
    named ``label``."""
    root = ET.parse(path).getroot()
    filename = root.find("filename").text
    boxes = []
    for obj in root.findall("object"):
        if obj.find("name").text != label:
            continue
        bb = obj.find("bndbox")
        boxes.append([int(bb.find(tag).text) for tag in ("ymin", "xmin", "ymax", "xmax")])
    return filename, np.array(boxes, dtype=int).reshape(-1, 4)


def read_voc_annotations(annotations_dir: str,
                         label: str = DEFAULT_LABEL) -> dict[str, np.ndarray]:
    """Every ``*.xml`` under a directory -> ``{image_filename: boxes}``."""
    annotations: dict[str, np.ndarray] = {}
    for f in glob.glob(os.path.join(annotations_dir, "*.xml")):
        filename, boxes = read_voc_file(f, label=label)
        annotations[filename] = boxes
    return annotations
