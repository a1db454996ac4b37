"""The port's marching cubes (``moco_flow_tpu_torch/ops/mcubes.py`` over its
copy of ``native/mcubes.cpp``) against the JAX package's, and its build.

On the same grids both return the same vertices and triangles bit for bit
and write the same OBJ text. The library is built under
``build/mcubes/<hash>/`` at the repository root, never beside the source,
and a failed build raises with the compiler's output.
"""

import os
import os.path as osp

import numpy as np
import pytest

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.ops import mcubes as jax_mc
from moco_flow_tpu_torch.ops import mcubes

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _sphere(n: int, noise: float = 0.0) -> np.ndarray:
    lin = np.linspace(-1.5, 1.5, n, dtype=np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    g = 20.0 * (1.0 - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2))
    if noise:
        g = g + np.random.default_rng(0).normal(
            scale=noise, size=g.shape).astype(np.float32)
    return g.astype(np.float32)


@pytest.mark.parametrize("n,noise,iso", [(24, 0.0, 10.0), (40, 0.0, 10.0),
                                         (32, 3.0, 5.0), (17, 0.0, 0.0)])
def test_marching_cubes_equals_jax(n, noise, iso):
    grid = _sphere(n, noise)
    v, t = mcubes.marching_cubes(grid, iso)
    jv, jt = jax_mc.marching_cubes(grid, iso)
    assert len(v) > 0 and v.dtype == np.float32 and t.dtype == np.int32
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


def test_empty_field_gives_no_mesh():
    v, t = mcubes.marching_cubes(np.zeros((8, 8, 8), np.float32), 1.0)
    assert v.shape == (0, 3) and t.shape == (0, 3)


def test_export_obj_equals_jax(tmp_path):
    v, t = mcubes.marching_cubes(_sphere(20), 10.0)
    mcubes.export_obj(v, t, str(tmp_path / "a" / "port.obj"))
    jax_mc.export_obj(v, t, str(tmp_path / "jax.obj"))
    assert (tmp_path / "a" / "port.obj").read_text() == \
        (tmp_path / "jax.obj").read_text()


def test_the_library_is_built_under_build(tmp_path, monkeypatch):
    path = mcubes.build()
    assert str(path).startswith(osp.join(ROOT, "build", "mcubes") + os.sep)
    native = osp.join(ROOT, "moco_flow_tpu_torch", "ops", "native")
    assert os.listdir(native) == ["mcubes.cpp"]
    # a source the compiler rejects: the build raises with its output
    bad = tmp_path / "mcubes.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(mcubes, "_SRC", bad)
    monkeypatch.setattr(mcubes, "_BUILD_ROOT", tmp_path / "out")
    with pytest.raises(RuntimeError, match="building mcubes.cpp failed"):
        mcubes.build()
