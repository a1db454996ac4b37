"""The port's offline toolchain (``moco_flow_tpu_torch/scripts/``) against
the JAX package's ``scripts/`` on the same seeded inputs, on the CPU.

- the rasterizer against ``scripts/rasterizer.py``: coverage (alpha) equal
  and rgb within 1e-6 (both sum a pixel's 3-term colour in fp64, in other
  orders, before rounding it to fp32), on JAX's triangle, a 512-vertex
  posed body at 64^2 and 96^2 from 4 views, and two coplanar faces that
  share an edge (the fp32 z-buffer's tie rule);
- ``keep_largest_region`` equal to cv2's, ``median_background`` equal to
  ``np.median`` (4 and 5 frames);
- the JSON files byte-equal to JAX's; the init_nerf PNGs within +-1 on at
  most 0.5% of pixels (the body is posed by each package's own SMPL in
  fp32, whose sums differ in the last bit), and the result loads in the
  port's ``MoCoFlowDataset``;
- ``convert_snapshot_gt`` (skipped without h5py, as JAX's test is),
  ``smpl_joints`` (1e-6 abs), ``out_channels``;
- ``validate_ps.py --fixtures`` end to end on ``--device cpu``.
"""

import json
import os
import os.path as osp
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.geometry.smpl import smpl_forward as jax_smpl_forward
from moco_flow_tpu.geometry.smpl import smpl_joints as jax_smpl_joints
from moco_flow_tpu.geometry.smpl import synthetic_smpl_data
from moco_flow_tpu.nn.embedding import out_channels as jax_out_channels
from moco_flow_tpu_torch.data.dataset import MoCoFlowDataset
from moco_flow_tpu_torch.geometry.smpl import smpl_joints
from moco_flow_tpu_torch.nn.embedding import out_channels
from moco_flow_tpu_torch.scripts import data_utils as du
from moco_flow_tpu_torch.scripts.rasterizer import rasterize_mesh
from moco_flow_tpu_torch.utils.image import read_png, write_png
from scripts import data_utils as jdu
from scripts.rasterizer import rasterize_mesh as jax_rasterize_mesh

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def raster_pair(verts, faces, colors, c2w, focal, center, size, bkgd=1.0):
    want = jax_rasterize_mesh(verts, faces, colors, c2w, focal, center,
                              size, bkgd=bkgd)
    got = rasterize_mesh(verts, faces, colors, c2w, focal, center, size,
                         bkgd=bkgd, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (*size, 4)
    return got.numpy(), want


def test_rasterizer_triangle():
    verts = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0, 0.5, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2]])
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    c2w = jdu.look_at_pose(np.array([0, 0, 2.0]), np.zeros(3))
    got, want = raster_pair(verts, faces, colors, c2w, 32.0, (16, 16),
                            (32, 32), bkgd=0.0)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[..., 3].sum() > 20 and got[16, 16, 3] == 1.0


@pytest.mark.parametrize("reso", [64, 96])
def test_rasterizer_posed_body(reso):
    smpl = synthetic_smpl_data(512)
    rng = np.random.default_rng(reso)
    pose = np.zeros((1, 72), np.float32)
    pose[:, 3:] = rng.normal(scale=0.1, size=(1, 69))
    transl = np.array([0.0, 0.1, 3.0], np.float32)
    verts = np.asarray(jax_smpl_forward(smpl, jnp.asarray(pose),
                                        jnp.zeros((1, 10))))[0] + transl
    colors = (verts - verts.min(0)) / (verts.max(0) - verts.min(0) + 1e-8)
    covered = 0
    for pos in jdu.sample_on_sphere(4, 3.0):
        c2w = jdu.look_at_pose(pos + transl, transl)
        got, want = raster_pair(verts, smpl.faces, colors, c2w, reso * 1.2,
                                (reso / 2, reso / 2), (reso, reso))
        np.testing.assert_array_equal(got[..., 3], want[..., 3])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        covered += int(want[..., 3].sum())
    assert covered > 0.05 * 4 * reso * reso


@pytest.mark.parametrize("dist", [2.0, 1.1])
@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_rasterizer_zbuffer_ties(dist, order):
    """Two fronto-parallel faces on one edge (their own vertices, red and
    blue): the edge's pixel centres are inside both at the same depth. At
    2.0 the fp32 z-buffer holds the depth exactly and the earlier face
    keeps the pixel; at 1.1 it rounds upward and the later face takes it.
    """
    s = 0.5
    verts = np.array([[-s, s, 0], [s, -s, 0], [-s, -s, 0],
                      [-s, s, 0], [s, -s, 0], [s, s, 0]], np.float64)
    colors = np.array([[1, 0, 0]] * 3 + [[0, 0, 1]] * 3, np.float64)
    faces = np.array([[0, 1, 2], [3, 4, 5]])[list(order)]
    c2w = jdu.look_at_pose(np.array([0, 0, dist]), np.zeros(3))
    args = (c2w, 32.0, (16, 16), (32, 32))
    got, want = raster_pair(verts, faces, colors, *args, bkgd=0.0)
    np.testing.assert_array_equal(got, want)
    alone = [jax_rasterize_mesh(verts, faces[i:i + 1], colors, *args,
                                bkgd=0.0)[..., 3] > 0 for i in (0, 1)]
    tie = alone[0] & alone[1]
    assert tie.sum() >= 10
    winner = faces[0] if dist == 2.0 else faces[1]
    np.testing.assert_array_equal(want[tie][:, :3],
                                  np.tile(colors[winner[0]], (tie.sum(), 1)))


def awkward_faces(seed: int, n: int = 300):
    """Separate triangles in front of a camera at the origin (looking down
    -z) that stress the rasterizer's row spans: random ones of 1e-3..10
    units, slivers, edges within 1e-13 of a row, edges on the pixel grid,
    and faces with a vertex 1e-5 in front of the camera (off-screen by
    1e5 pixels)."""
    rng = np.random.default_rng(seed)
    tris = []
    for i in range(n):
        c = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                      -rng.uniform(1, 5)])
        s = 10 ** rng.uniform(-3, 1)
        r = c + s * rng.normal(size=(3, 3))
        kind = i % 5
        if kind == 1:
            r[1] = r[0] + 1e-6 * rng.normal(size=3)
        elif kind == 2:
            r[1] = r[0] + [s * rng.normal(), 1e-13 * rng.normal(), 0]
        elif kind == 3:
            q = np.round(c * 8) / 8
            r = np.stack([q, q + [0.25, 0, 0], q + [0, 0.25, 0]])
        elif kind == 4:
            r[2] = [0.1 * rng.normal(), 0.1 * rng.normal(),
                    -1e-5 - 1e-6 * rng.random()]
        tris.append(r)
    verts = np.concatenate(tris)
    return verts, np.arange(len(verts)).reshape(-1, 3), rng.random(
        verts.shape)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 1])
def test_rasterizer_awkward_faces(seed, dtype):
    """Every pixel the numpy loop draws, with the loop's winner: overlapping
    faces of distinct colours, in the loop's dtypes, on a non-square
    frame."""
    verts, faces, colors = awkward_faces(seed)
    got, want = raster_pair(verts.astype(dtype), faces, colors,
                            np.eye(4, dtype=dtype), 40.0, (26.5, 18.5),
                            (37, 53))
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert want[..., 3].mean() > 0.2


def bridged_mask(seed: int) -> np.ndarray:
    """Seeded blobs joined and split by one-pixel diagonal bridges, which
    only 8-connectivity joins."""
    rng = np.random.default_rng(seed)
    m = (rng.random((40, 48)) < 0.35).astype(np.uint8) * 255
    for _ in range(6):
        r, c = rng.integers(2, 30), rng.integers(2, 38)
        for k in range(8):
            m[r + k, c + k] = 200
    m[0, 0] = m[1, 1] = 255
    return m


@pytest.mark.parametrize("seed", range(4))
def test_keep_largest_region_matches_cv2(seed):
    mask = bridged_mask(seed)
    got = du.keep_largest_region(mask)
    np.testing.assert_array_equal(got, jdu.keep_largest_region(mask))
    assert got.dtype == np.uint8 and 0 < got.sum() < (mask > 0).sum()


def test_keep_largest_region_ties_and_empty():
    two = np.zeros((8, 8), np.uint8)
    two[1:3, 5:7] = 1          # first in raster order
    two[5:7, 0:2] = 1
    np.testing.assert_array_equal(du.keep_largest_region(two),
                                  jdu.keep_largest_region(two))
    assert du.keep_largest_region(two)[1, 5] == 1
    empty = np.zeros((5, 6), np.uint8)
    np.testing.assert_array_equal(du.keep_largest_region(empty), empty)


@pytest.mark.parametrize("n_frames", [4, 5])
def test_median_background(tmp_path, n_frames):
    rng = np.random.default_rng(n_frames)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(n_frames):
        im = rng.integers(0, 256, size=(20, 24, 4), dtype=np.uint8)
        write_png(str(imgs / f"{i:04d}.png"), im)
    got = du.median_background(str(imgs), None, str(tmp_path / "bg.png"),
                               device="cpu")
    want = jdu.median_background(str(imgs), None, str(tmp_path / "bg_j.png"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(str(tmp_path / "bg.png")), want)
    if n_frames % 2 == 0:      # the mean of two middle values, truncated
        assert (np.median(np.stack([read_png(str(imgs / f))[..., :3]
                                    for f in sorted(os.listdir(imgs))]),
                          0) % 1 == 0.5).any()


def fake_vibe_pkl(path, n_frames=3, seed=0, transls=False):
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_frames, 72), np.float32)
    poses[:, 3:] = rng.normal(scale=0.1, size=(n_frames, 69))
    person = {"frame_ids": np.arange(n_frames), "pose": poses,
              "betas": rng.normal(scale=0.1, size=(n_frames, 10)).astype(
                  np.float32)}
    if transls:
        person["transls"] = (rng.normal(scale=0.05, size=(n_frames, 3))
                             + [0, 0, 3.0]).astype(np.float32)
    else:
        person["orig_cam"] = np.tile([1.0, 1.0, 0.0, 0.0], (n_frames, 1))
        person["orig_cam"][:, 2:] += rng.normal(scale=0.1, size=(n_frames,
                                                                 2))
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({1: person}, f)
    return path


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("transls", [False, True], ids=["orig_cam",
                                                        "transls"])
def test_create_moco_flow_data_bytes(tmp_path, transls):
    outs = {}
    for who, fn in (("port", du.create_moco_flow_data),
                    ("jax", jdu.create_moco_flow_data)):
        pkl = fake_vibe_pkl(str(tmp_path / who / "vibe_output.pkl"),
                            transls=transls)
        outs[who] = fn(pkl, (64, 80), focal=80.0, c=None if transls else
                       [41.5, 30.25], gender="f")
        for name in ("train.json", "val.json"):
            assert osp.exists(tmp_path / who / name)
    for name in ("train.json", "val.json"):
        assert read_bytes(tmp_path / "port" / name) == read_bytes(
            tmp_path / "jax" / name)
    assert len(outs["port"]["frames"]) == 3


def test_create_init_nerf_data(tmp_path):
    smpl = synthetic_smpl_data(128)
    for who, fn in (("port", du.create_init_nerf_data),
                    ("jax", jdu.create_init_nerf_data)):
        pkl = fake_vibe_pkl(str(tmp_path / who / "vibe_output.pkl"))
        kw = {"device": "cpu"} if who == "port" else {}
        fn(pkl, (48, 48), focal=60.0, num_images=6, smpl_data=smpl, **kw)
    for name in ("train.json", "val.json"):
        assert read_bytes(tmp_path / "port" / "init_nerf" / name) == \
            read_bytes(tmp_path / "jax" / "init_nerf" / name)
    from PIL import Image
    pixels = off = 0
    for i in range(6):
        got = read_png(str(tmp_path / "port" / "init_nerf" / "images"
                           / f"{i:04d}.png"))
        want = np.asarray(Image.open(tmp_path / "jax" / "init_nerf"
                                     / "images" / f"{i:04d}.png"))
        assert got.shape == want.shape == (48, 48, 4)
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1
        off += int((diff > 0).any(-1).sum())
        pixels += 48 * 48
    assert off <= 0.005 * pixels
    root = str(tmp_path / "port" / "init_nerf")
    img = read_png(osp.join(root, "images", "0000.png"))
    assert (img[..., 3] > 0).sum() > 10
    ds = MoCoFlowDataset(root, "images", (48, 48),
                         [[1.2, 1.2, 1.2], [0, 0, 0]], 1.0, smpl_data=smpl)
    assert ds.num_frames == 6 and ds.has_alpha
    rays = ds.frame_rays(0)
    assert rays.shape == (48 * 48, 9)
    alpha = (img[..., 3] > 0).reshape(-1)
    hull = ds.frame_mask(0)
    assert (alpha & ~np.asarray(hull)).sum() <= alpha.sum() * 0.3


def test_sample_on_sphere_and_look_at_match():
    np.testing.assert_array_equal(du.sample_on_sphere(32, 3.0),
                                  jdu.sample_on_sphere(32, 3.0))
    for eye in ([0, 0, 4.0], [0, 5.0, 0], [1.0, 2.0, -3.0]):
        np.testing.assert_array_equal(
            du.look_at_pose(np.array(eye), np.zeros(3)),
            jdu.look_at_pose(np.array(eye), np.zeros(3)))


def test_snapshot_gt_converter(tmp_path):
    """GT triplet -> the same VIBE-schema pkl as JAX's, and a JSON byte-equal
    to JAX's from it."""
    pytest.importorskip("h5py")
    from moco_flow_tpu_torch.scripts.preprocess_snapshot_data import \
        convert_snapshot_gt
    from scripts.preprocess_snapshot_data import \
        convert_snapshot_gt as jax_convert
    from tests.test_preprocess import fake_snapshot_gt

    fake_snapshot_gt(tmp_path / "gt", n_frames=5)
    out = {}
    for who, fn in (("port", convert_snapshot_gt), ("jax", jax_convert)):
        (tmp_path / who).mkdir()
        pkl = str(tmp_path / who / "converted.pkl")
        out[who] = fn(str(tmp_path / "gt"), pkl, start_frame=1, end_frame=5,
                      interval=2)
        jdu.create_moco_flow_data(pkl, (96, 96), focal=out[who][1],
                                  c=out[who][2], gender="m")
    (got, gf, gc), (want, wf, wc) = out["port"], out["jax"]
    assert gf == wf == 910.0
    np.testing.assert_array_equal(gc, wc)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert read_bytes(tmp_path / "port" / "train.json") == read_bytes(
        tmp_path / "jax" / "train.json")


def test_smpl_joints_and_out_channels():
    smpl = synthetic_smpl_data(300)
    verts = np.random.default_rng(0).normal(size=(2, 300, 3)).astype(
        np.float32)
    got = smpl_joints(smpl, torch.from_numpy(verts))
    want = np.asarray(jax_smpl_joints(smpl, jnp.asarray(verts)))
    assert got.shape == (2, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for c, n in ((3, 10), (3, 0), (1, 16), (3, 4)):
        assert out_channels(c, n) == jax_out_channels(c, n)


@pytest.mark.parametrize("module", ["preprocess_data",
                                    "preprocess_snapshot_data",
                                    "drive_pipeline_e2e", "validate_ps"])
def test_cli_device_cuda_without_a_card(module, tmp_path, monkeypatch):
    """Each CLI defaults to the card and fails where there is none."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"moco_flow_tpu_torch.scripts.{module}")
    argv = {"preprocess_data": ["--video", "v.mp4", "--out_dir",
                                str(tmp_path)],
            "preprocess_snapshot_data": ["--input_video", "v.mp4",
                                         "--output_folder", str(tmp_path)],
            "drive_pipeline_e2e": ["--base", str(tmp_path)],
            "validate_ps": ["--fixtures", "--work", str(tmp_path)]}[module]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not os.listdir(tmp_path)


def test_validate_ps_fixtures(tmp_path):
    """The People-Snapshot runbook on fabricated fixtures, end to end on
    the CPU: GT triplet -> converter -> dataset -> the three stages'
    CLIs -> the test CLI's --eval_metrics."""
    pytest.importorskip("h5py")
    r = subprocess.run(
        [sys.executable, "-m", "moco_flow_tpu_torch.scripts.validate_ps",
         "--fixtures", "--work", str(tmp_path / "vps"), "--reso", "24",
         "--frames", "2", "--steps", "6", "--eval_max_frames", "1",
         "--stage_timeout", "600", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["mode"] == "trained" and out["frames"] == 1
    assert np.isfinite(out["psnr"]) and np.isfinite(out["ssim"])
    data = tmp_path / "vps" / "data"
    assert len(os.listdir(data / "images")) == 2
    assert len(os.listdir(data / "init_nerf" / "images")) == 12
