"""``benchmark/counts.py`` against counts by hand at a small width."""

import json
from pathlib import Path

import pytest

from benchmark import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def tiny(extra_type="ind", quat=True, local=True, glob=True):
    nerf = {"D": 2, "W": 4, "in_channels_xyz": 9, "skips": [1],
            "extra_feat_type": extra_type, "extra_feat_dim": 2}
    nof = {"D": 3, "W": 2, "in_channels_xyz": 9, "skips": [2],
           "extra_feat_type": "ind", "extra_feat_dim": 3, "use_quat": quat}
    return {"model": {"type": "moco_flow", "N_rand": 5, "N_samples": 3,
                      "N_importance": 2, "N_sampled": 7,
                      "nerf_embedding_xyz": {"N_freqs": 1},
                      "coarse_NeRF": nerf, "fine_NeRF": nerf,
                      "bw_NoF": nof, "fw_NoF": nof},
            "loss": {"chain_local": local, "chain_global": glob}}


def test_nerf_net_by_hand():
    # trunk: 9*4, skip layer 4*4 + 9*4; sigma 4; final 16; extra 4*2;
    # rgb 2*3; the extra feature's rows 2*2 once a ray
    net = counts.nerf_net(tiny())
    assert net.sample_macs == 36 + 16 + 36 + 4 + 16 + 8 + 6
    assert net.ray_macs == 4
    assert net.params == (9 + 1) * 4 + (4 + 9 + 1) * 4 + 5 + 20 + 7 * 2 + 9
    sig = counts.nerf_net(tiny(), sigma_only=True)
    assert (sig.sample_macs, sig.ray_macs) == (36 + 52 + 4, 0)


@pytest.mark.parametrize("quat", [True, False])
def test_nof_net_by_hand(quat):
    # layer 0: 9*2 per sample, 3*2 per ray; layer 1: 2*2; skip layer 2:
    # (2+9)*2 per sample, 3*2 per ray; head 2*9 (quaternion) or 2*3
    net = counts.nof_net(tiny(quat=quat))
    head = 9 if quat else 3
    assert net.sample_macs == 18 + 4 + 22 + 2 * head
    assert net.ray_macs == 12
    assert net.params == 13 * 2 + 3 * 2 + (2 + 12 + 1) * 2 + 3 * head


@pytest.mark.parametrize("local,glob,want", [(False, False, (1, 1)),
                                             (True, False, (2, 2)),
                                             (True, True, (5, 4))])
def test_chain_evals(local, glob, want):
    assert counts.chain_evals(tiny(local=local, glob=glob)) == want


@pytest.mark.parametrize("name", ["c2f", "init_nerf", "tiny"])
def test_backward_is_twice_forward(name):
    cfg = tiny() if name == "tiny" else json.load(open(CONFIGS /
                                                       f"{name}.json"))
    launches = counts.step_launches(cfg, "msk")
    pairs = {"#2": "#1", "#4": "#3", "#6": "#5"}
    for i, bwd in enumerate(launches):
        if bwd.kernel in pairs:
            fwd = launches[i - 1]
            assert fwd.kernel == pairs[bwd.kernel]
            assert bwd.flops == 2 * fwd.flops


def test_step_launches_by_hand():
    cfg = tiny()
    ks = [x.kernel for x in counts.step_launches(cfg, "msk")]
    assert ks == ["#1", "#2", "#1", "#2", "#5", "#6", "#5", "#6", "#3", "#4"]
    assert [x.kernel for x in counts.step_launches(cfg, "none")] == ks[:8]
    first = counts.step_launches(cfg, "msk")[0]
    assert first.flops == 2.0 * 5 * 3 * 122
    # xyz in, the extra partial, the weights, rgb + sigma out
    assert first.bytes == 4 * (3 * 15 + 5 * 2 + 144 + 4 * 15)
    chain = counts.step_launches(cfg, "msk")[4]
    assert chain.flops == 2.0 * 5 * 3 * 5 * 62


def test_step_model_flops_by_hand():
    cfg = tiny()
    # NeRF on 3 + 5 samples a ray, its extra rows twice a ray; the chain's
    # 5 NoF evaluations on 3 + 2 samples, its 4 partial sets on both sample
    # sets; msk: the bw NoF on 14 points and both NeRFs' sigma on them
    fwd = (5 * 8 * 122 + 2 * 5 * 4 + 5 * 5 * 5 * 62 + 2 * 5 * 4 * 12
           + 14 * 62 + 12 + 2 * 14 * 92)
    assert counts.step_model_flops(cfg, "msk") == 6.0 * fwd
    stage1 = json.loads(json.dumps(cfg))
    stage1["model"]["type"] = "nerf"
    assert counts.step_model_flops(stage1, None) == 6.0 * (5 * 8 * 122
                                                           + 2 * 5 * 4)


def test_bound_takes_the_longer():
    fl = counts.Launch("#1", flops=counts.PEAK_FLOPS, bytes=1.0)
    by = counts.Launch("#1", flops=1.0, bytes=2 * counts.PEAK_BYTES)
    assert fl.bound_s == pytest.approx(1.0)
    assert by.bound_s == pytest.approx(2.0)
