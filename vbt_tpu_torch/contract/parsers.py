"""Parsers of the ground truth the port is held against.

Copy of ``vbt_tpu.contract.parsers``, with pandas imported inside the
functions that build dataframes:

- Kinovea trajectory exports: ``#`` comments, space-delimited ``T X Y``
  rows with comma decimal separators, centimetres;
- Qualisys motion-capture exports: 11 header rows, tab-delimited, the
  ``Osa L X`` / ``Osa L Z`` marker columns, millimetres, x negated;
- PASCAL-VOC detection annotations: ``<object><name>barbell</name><bndbox>``
  boxes as ``[ymin, xmin, ymax, xmax]`` integer rows.
"""

from __future__ import annotations

import glob
import os
import xml.etree.ElementTree as ET

import numpy as np

DEFAULT_LABEL = "barbell"


def read_kinovea_export(path: str):
    """A Kinovea trajectory export -> a (time, x, y) dataframe in meters."""
    import pandas as pd

    df = pd.read_csv(
        path,
        comment="#",
        header=None,
        names=["time", "x", "y"],
        delimiter=" ",
        dtype={"time": float},
        converters={
            "x": lambda v: float(v.replace(",", ".")),
            "y": lambda v: float(v.replace(",", ".")),
        },
        index_col=False,
    )
    df["x"] = df["x"] / 100.0
    df["y"] = df["y"] / 100.0
    return df


def read_qualisys_export(path: str):
    """A Qualisys mocap tsv -> a (time, x, y) dataframe in meters: the
    ``Osa L`` marker's X (negated) and Z axes after the 11-row header."""
    import pandas as pd

    df = pd.read_csv(
        path,
        delimiter="\t",
        skiprows=11,
        usecols=["Time", "Osa L X", "Osa L Z"],
        index_col=False,
    )
    df = df.rename(columns={"Time": "time", "Osa L X": "x", "Osa L Z": "y"})
    df["x"] = -df["x"] / 1000.0
    df["y"] = df["y"] / 1000.0
    return df


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
