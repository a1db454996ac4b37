"""Point-cloud PLY writers: binary little-endian PLY without the plyfile
package.

Port of ``moco_flow_tpu/utils/ply.py``; the files are byte for byte the
JAX package's.
"""

from __future__ import annotations

import struct

import numpy as np


def write_ply(points: np.ndarray, filename: str):
    """(N, 3) float points -> binary PLY."""
    points = np.asarray(points, np.float32)
    with open(filename, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(points)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"end_header\n")
        f.write(points.astype("<f4").tobytes())


def write_ply_rgb(points: np.ndarray, filename: str):
    """(N, 6) [xyz, rgb 0-255] -> binary PLY with colours."""
    points = np.asarray(points)
    with open(filename, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(points)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property uchar red\nproperty uchar green\n"
                b"property uchar blue\nend_header\n")
        for p in points:
            f.write(struct.pack("<fffBBB", p[0], p[1], p[2],
                                int(p[3]), int(p[4]), int(p[5])))
