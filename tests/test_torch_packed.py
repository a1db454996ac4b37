"""The port's packed stream of views (``moco_flow_tpu_torch/render/
packed.py``) and the trainer's view path (``render_views_pipelined``)
with occupancy skipping, against the per-view render and JAX's.

The JAX / port trainer pair of ``tests/test_torch_occupancy.py`` (the
training fixture's widths, a field with ~40% of a 24^2 frame's rays
provably empty at ``occ_res`` 8).

- the packed stream equals the per-view render (``prepare_view`` /
  ``commit_view``) to the bit, through ``render_views_pipelined`` and
  driven directly with 128-row segments and a window of 2 (several drains
  a view, views across segments, slots reused in flight, a view with no
  kept ray, the flush), with the window cut by the byte cap, and under
  ``mlp_impl: pallas``;
- ``render_views_pipelined`` without skipping, and with ``masked_render:
  loop`` (a view at a time), equals a view at a time;
- ``render_views_pipelined`` with occupancy equals JAX's: rgb within 1e-5;
- ``kept_indices`` against ``nonzero``; the render pass's per-ray
  partials (``folds._rows_matmul``) the same bits in any batch.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu_torch.ops.folds import ROW_TILE, _rows_matmul
from moco_flow_tpu_torch.render import packed
from moco_flow_tpu_torch.render.packed import PackedStream, kept_indices
from tests.test_torch_occupancy import SIZE, make_pair, model_keys

N = SIZE * SIZE


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair(str(tmp_path_factory.mktemp("packed")))


def _jobs(pt, frames, masks=None):
    out = []
    for i, frame in enumerate(frames):
        bg = torch.full((N, 3), 0.1 + 0.1 * i)
        out.append((pt.val_dataset.frame_rays(frame), frame, bg,
                    None if masks is None else masks[i]))
    return out


def _per_view(pt, jobs, skip=True, rcfg=None):
    return [pt.commit_view(pt.prepare_view(r, f, extra_mask=m, skip=skip),
                           bg, rcfg or pt.rcfg_test, anneal=pt.anneal())
            for r, f, bg, m in jobs]


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(),
                                          err_msg=f"view {i} {k}")


def test_kept_indices():
    keep = torch.from_numpy(np.random.default_rng(0).random(1000) < 0.3)
    count = int(keep.sum())
    want = torch.nonzero(keep)[:, 0]
    np.testing.assert_array_equal(kept_indices(keep, count), want)
    got = kept_indices(keep, count + 37)
    np.testing.assert_array_equal(got[:count], want)
    assert (got[count:] == 1000).all()
    np.testing.assert_array_equal(kept_indices(keep, 10), want[:10])


def test_rows_matmul_is_row_stable():
    """The per-ray partials are GEMMs of one shape, so a ray's bits do not
    depend on the rows around it (a BLAS picks its kernel from the shape:
    on the card the extra partial of a 4096-ray tile differed from the same
    rays' in a 16384-ray one when it was one GEMM a call)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3000 + 2 * ROW_TILE, 33, generator=gen)
    w = torch.randn(33, 128, generator=gen)
    full = _rows_matmul(x, w)
    for a, b in ((0, 1), (0, 1000), (1234, 3000), (5, ROW_TILE + 7),
                 (ROW_TILE - 3, x.shape[0])):
        assert torch.equal(_rows_matmul(x[a:b], w), full[a:b])
    assert _rows_matmul(x[:0], w).shape == (0, 128)
    np.testing.assert_allclose(full.numpy(), (x.double() @ w.double()).numpy(),
                               rtol=0, atol=1e-4)


def test_packed_equals_per_view(pair):
    _, pt, _ = pair
    hull = np.zeros(N, bool)
    hull[::3] = True
    jobs = _jobs(pt, (0, 1, 2, 0, 1), [None, None, hull, None, None])
    _equal(list(pt.render_views_pipelined(jobs, pt.rcfg_test,
                                          anneal=pt.anneal())),
           _per_view(pt, jobs))


def test_packed_equals_per_view_pallas(pair):
    """The same under ``mlp_impl: pallas`` (#8 / #9 a segment, their plain
    versions here)."""
    _, pt, _ = pair
    rcfg = dataclasses.replace(pt.rcfg_test, mlp_impl="pallas")
    hull = np.zeros(N, bool)
    hull[::3] = True
    jobs = _jobs(pt, (0, 1, 2, 0), [None, hull, None, None])
    _equal(list(pt.render_views_pipelined(jobs, rcfg, anneal=pt.anneal())),
           _per_view(pt, jobs, rcfg=rcfg))


def test_packed_small_segments(pair):
    """128-row segments and a window of 2: several drains a view, views
    across segment boundaries, slots reused while in flight, a view with
    no kept ray, and the flush."""
    _, pt, _ = pair
    none = np.zeros(N, bool)
    jobs = _jobs(pt, (0, 1, 2, 0, 1, 2, 0),
                 [None, None, none, None, None, None, None])
    handles = [pt.prepare_view(r, f, extra_mask=m) for r, f, _, m in jobs]
    want = [pt.commit_view(h, bg, pt.rcfg_test, anneal=pt.anneal())
            for h, (_, _, bg, _) in zip(handles, jobs)]
    stream = PackedStream(pt, pt.rcfg_test, pt.anneal(), n_rays=N,
                          ray_cols=handles[0][0].shape[1], seg=128, window=2)
    got = []
    for h, (_, _, bg, _) in zip(handles, jobs):
        rays_t, keep, _, count = h
        got += stream.add_view(rays_t, keep, int(count), bg)
    assert int(handles[2][3]) == 0 and stream.drained > 0
    got += stream.flush()
    _equal(got, want)


def test_the_byte_cap_cuts_the_window(pair, monkeypatch):
    _, pt, _ = pair
    slot = N * 5 * 4
    buf = (N + packed.SEG) * (9 + 3 + 1) * 4     # 9 ray columns
    monkeypatch.setattr(packed, "PACK_BYTES", buf + slot)
    jobs = _jobs(pt, (0, 1, 2))
    stream = PackedStream(pt, pt.rcfg_test, pt.anneal(), N, 9)
    assert stream.w == 1
    _equal(list(pt.render_views_pipelined(jobs, pt.rcfg_test,
                                          anneal=pt.anneal())),
           _per_view(pt, jobs))


@pytest.mark.parametrize("skip,impl", [(False, "fused"), (True, "loop")])
def test_view_at_a_time_paths(pair, skip, impl):
    _, pt, _ = pair
    hull = np.zeros(N, bool)
    hull[::2] = True
    jobs = _jobs(pt, (0, 1, 0), [None, hull, None])
    with model_keys(pt, masked_render=impl):
        got = list(pt.render_views_pipelined(jobs, pt.rcfg_test,
                                             anneal=pt.anneal(), skip=skip))
        _equal(got, _per_view(pt, jobs, skip=skip))


def test_pipelined_views_equal_jax(pair):
    jt, pt, _ = pair
    hull = np.zeros(N, bool)
    hull[::3] = True
    jobs = _jobs(pt, (0, 2, 1), [None, hull, None])
    got = list(pt.render_views_pipelined(jobs, pt.rcfg_test,
                                         anneal=pt.anneal()))
    jjobs = [(jt.val_dataset.frame_rays(f)[0], f, jnp.asarray(bg.numpy()), m)
             for _, f, bg, m in jobs]
    want = list(jt.render_views_pipelined(iter(jjobs), jt.rcfg_test,
                                          anneal=jt.anneal()))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["rgb_fine"].numpy(),
                                   np.asarray(b["rgb_fine"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(a["opacity_fine"].numpy() > 0,
                                      np.asarray(b["opacity_fine"]) > 0)
    assert 0 < float(got[0]["opacity_fine"].mean()) < 1
