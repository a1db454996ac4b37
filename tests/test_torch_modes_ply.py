"""The dataset modes and the PLY writers of the port against the JAX
package.

- ``MoCoFlowDataset`` in every mode JAX's accepts: a ``test.json`` beside
  the scene's ``train.json`` / ``val.json`` is read for ``test`` and
  ``test/vis``, the part after the ``/`` is ``vis_mode``, the frame table
  (cameras, near / far, valid pixels) equals JAX's exactly in each mode but
  ``val``, and only ``val`` builds the spherical poses.
- ``write_ply`` and ``write_ply_rgb`` write JAX's files byte for byte.
"""

import json
import os.path as osp
import shutil

import numpy as np
import pytest

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.dataset import MoCoFlowDataset as JDataset
from moco_flow_tpu.data.synthetic import make_synthetic_scene
from moco_flow_tpu.utils import ply as jply
from moco_flow_tpu_torch.data.dataset import MoCoFlowDataset
from moco_flow_tpu_torch.utils import ply as tply

AABB = [[1.2, 1.2, 1.2], [0, 0, 0]]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("modes"))
    smpl = make_synthetic_scene(root, n_frames=3, size=16, focal=20.0)
    with open(osp.join(root, "train.json")) as f:
        meta = json.load(f)
    meta["frames"] = meta["frames"][1:]       # another sequence
    with open(osp.join(root, "test.json"), "w") as f:
        json.dump(meta, f)
    return root, smpl


@pytest.mark.parametrize("mode", ["train", "val", "test", "test/vis",
                                  "train/novel"])
def test_dataset_modes_match_jax(scene, mode):
    root, smpl = scene
    kw = dict(size=(16, 16), aabb=AABB, bkgd=1.0, mode=mode,
              smpl_data=smpl)
    got = MoCoFlowDataset(root, "images", **kw)
    want = JDataset(root, "images", **kw)
    assert (got.mode, got.vis_mode) == (want.mode, want.vis_mode)
    assert got.num_frames == want.num_frames
    assert hasattr(got, "spherical_poses") == (mode == "val") == \
        hasattr(want, "spherical_poses")
    if mode == "val":
        np.testing.assert_allclose(got.spherical_poses,
                                   np.asarray(want.spherical_poses),
                                   rtol=0, atol=1e-6)
        return
    for name in ("valid_idx", "valid_count"):
        np.testing.assert_array_equal(
            getattr(got.table, name).numpy(),
            np.asarray(getattr(want.table, name)), err_msg=name)
    for name in ("c2w", "near", "far", "norm_idx"):
        np.testing.assert_allclose(
            getattr(got.table, name).numpy(),
            np.asarray(getattr(want.table, name)), rtol=0, atol=1e-5,
            err_msg=name)


def test_write_ply_is_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(37, 3))
    rgb = np.concatenate([pts, rng.integers(0, 256, (37, 3))], axis=1)
    for fn, data in (("write_ply", pts), ("write_ply_rgb", rgb)):
        a, b = tmp_path / f"{fn}_port.ply", tmp_path / f"{fn}_jax.ply"
        getattr(tply, fn)(data, str(a))
        getattr(jply, fn)(data, str(b))
        assert a.read_bytes() == b.read_bytes(), fn
    shutil.rmtree(tmp_path)
