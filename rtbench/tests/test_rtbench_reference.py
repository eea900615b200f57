"""The plain reference on a scene checkable by hand (one plate, one ray,
one bounce), and against the program's op path on the soup at a small
size."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import compare  # noqa: E402
from rtbench.check import Reference, program_sample  # noqa: E402
from rtbench.reference import tracer as ref  # noqa: E402

C = 299792458.0
F = 3.0e9
CONCRETE = dict(a=5.24, b=0.0, c=0.0462, d=0.7822, s=0.5, s1_alpha=4.0)
PLATE = (np.array([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]],
                  np.float32), np.array([[0, 1, 2], [0, 2, 3]]), 1)


def hand_one_bounce(tx, rx):
    """The scatter gain, delay and RX direction of the ray straight down
    from ``tx`` onto the plate z = 0 towards ``rx``, by the formulas in
    float64 (ITU-R P.2040 eqs. 31a/31b with the C reference's eq. 33,
    the 1 - s reduction, free-space loss per segment, the directive
    scattering lobe)."""
    m = CONCRETE
    f_ghz = F / 1e9
    eta = complex(m["a"] * f_ghz ** m["b"],
                  m["c"] * f_ghz ** m["d"] / (0.0556325027352135 * f_ghz))
    cos1 = 1.0 - 2.0 ** -23          # the clamp below normal incidence
    sin1 = np.sqrt(1 - cos1 ** 2)
    inv = 1 / eta
    a2 = abs(eta) ** 2
    cos2 = complex(np.sqrt(1 + inv.real / a2 * sin1 ** 2),
                   np.sqrt(1 - inv.imag / a2 * sin1 ** 2))
    se = np.sqrt(eta)
    r_te = (cos1 - se * cos2) / (cos1 + se * cos2) * (1 - m["s"])
    r_tm = (se * cos1 - cos2) / (se * cos1 + cos2) * (1 - m["s"])
    fslm = 4 * np.pi * F / C
    t = tx[2]
    hit = np.array([tx[0], tx[1], 0.0])
    o2 = hit + np.array([0, 0, 1e-4])
    ds = np.asarray(rx, float) - o2
    dist = np.linalg.norm(ds)
    ds /= dist
    cos_ts = ds[2]
    theta_s, theta_i = np.arccos(cos_ts), np.arccos(cos1)
    f = m["s"] * np.exp(-m["s1_alpha"] * abs(theta_s - theta_i))
    rough = 1 / (1 + m["s1_alpha"])
    te_re = f * cos_ts
    tm_re = f * (rough * cos_ts * cos1 + (1 - rough) * cos_ts)
    ph = np.sin(m["s1_alpha"] * sin1 * 0.1)
    s_te, s_tm = complex(te_re, te_re * ph), complex(tm_re, tm_re * ph)
    norm = np.sqrt(abs(s_te) ** 2 + abs(s_tm) ** 2)
    scale = 1 / (fslm * t) ** 2 / (fslm * dist) ** 2
    return (r_te * s_te / norm * scale, r_tm * s_tm / norm * scale,
            (t + dist) / C, -ds)


@pytest.mark.parametrize("tx,rx", [((1.0, -1.0, 2.0), (1.0, 0.0, 1.0)),
                                   ((-2.0, 1.5, 3.0), (0.5, 0.5, 2.0))])
def test_one_plate_one_bounce_by_hand(tx, rx):
    scene = ref.scene_from_meshes([PLATE], False, "cpu")
    su = ref.Setup(scene, torch.tensor([rx]), torch.tensor(tx), 3.0,
                   "physical")
    mats = {k: torch.tensor([v]) for k, v in CONCRETE.items()}
    scene = ref.RefScene(scene.v0, scene.e1, scene.e2, scene.normal,
                         torch.zeros_like(scene.material), scene.velocity)
    su.scene = scene
    eta = ref.precompute_eta(mats, 3.0)
    outs, _ = ref.trace_rays(su, eta, torch.tensor([[0.0, 0.0, -1.0]]), 1)
    o = outs[0]
    te, tm, tau, dir_rx = hand_one_bounce(np.array(tx), rx)
    got_te = complex(o["te_re"][0, 0], o["te_im"][0, 0])
    got_tm = complex(o["tm_re"][0, 0], o["tm_im"][0, 0])
    assert abs(got_te - te) <= 1e-4 * abs(te)
    assert abs(got_tm - tm) <= 1e-4 * abs(tm)
    assert float(o["tau"][0, 0]) == pytest.approx(tau, rel=1e-6)
    assert np.allclose(o["dir_rx"][0, 0].numpy(), dir_rx, atol=1e-6)
    a, tau_los, _, _, _ = ref.los_pass(su)
    dist = np.linalg.norm(np.subtract(rx, tx))
    assert float(a[0]) == pytest.approx(1 / (4 * np.pi * F / C * dist),
                                        rel=1e-6)
    assert float(tau_los[0]) == pytest.approx(dist / C, rel=1e-6)


def test_a_ray_that_misses_carries_nothing():
    scene = ref.scene_from_meshes([PLATE], False, "cpu")
    su = ref.Setup(scene, torch.tensor([[0.0, 0.0, 1.0]]),
                   torch.tensor([0.0, 0.0, 2.0]), 3.0, "physical")
    eta = ref.precompute_eta({k: torch.tensor([v] * 2)
                              for k, v in CONCRETE.items()}, 3.0)
    outs, hits = ref.trace_rays(su, eta, torch.tensor([[0.0, 0.0, 1.0]]), 2)
    for o, h in zip(outs, hits):
        assert float(o["te_re"].abs().sum() + o["tm_re"].abs().sum()) == 0
        assert int(h["idx"][0]) == -1


@pytest.mark.parametrize("parity,nrx", [("reference", 1), ("reference", 3),
                                        ("physical", 2)])
def test_reference_equals_the_programs_op_path(parity, nrx):
    """The reference against ``compute_paths`` on the soup at
    2,048 paths: every sampled entry within the comparison's tolerances."""
    from hermespy_rt_tpu_torch import api
    from hermespy_rt_tpu_torch.scene import HostMesh, HostScene
    from rtbench import harness
    from rtbench.tests.tiny import RTBENCH
    cfg = harness.load_json(os.path.join(RTBENCH, "configs",
                                         "soup234.json"))
    meshes = harness.load_module(os.path.join(RTBENCH, "scenes", "soup.py"),
                                 "s").generate(cfg["scene"], "")["meshes"]
    scene = api.prepare_scene(HostScene([HostMesh(v, f, material_index=m)
                                         for v, f, m in meshes]),
                              device="cpu")
    rx = np.array([[10.0, 5.0, 2.0], [-3.0, 4.0, 1.5], [20, -8, 2.5]],
                  np.float32)[:nrx]
    tx = np.array([[-20.0, -10.0, 10.0]], np.float32)
    P, B = 2048, 3
    los, sc = api.compute_paths(scene, rx, tx, None, None, 3.0, nrx, 1, P,
                                B, device="cpu", parity=parity)
    ids = torch.arange(0, P, 3)
    r = Reference(meshes, False, tx, 3.0, parity, P, B,
                  "fibonacci" if parity == "reference" else "coherent", "cpu")
    want = r.sample(rx, ids, Reference.materials(cfg["materials"], "cpu",
                                                 torch.float32),
                    torch.float32)
    got = program_sample(los, sc, ids, B, P)
    bad, live = compare.mismatch_counts(got, want)
    assert live > 50 and bad == 0


@pytest.mark.parametrize("kw", ["none", "exclude", "all"])
def test_tile_scan_answers_as_the_brute_scan(tmp_path, kw):
    """Large scenes are scanned tile by tile; every answer (t's bits and
    the triangle, ties included) is the brute scan's."""
    from rtbench import harness
    from rtbench.tests.tiny import RTBENCH
    city = harness.load_module(os.path.join(RTBENCH, "scenes", "city.py"),
                               "c")
    out = city.generate(dict(n_buildings=36, sub=4, ground_sub=16,
                             extent=150.0, seed=0, zlift=0.05), str(tmp_path))
    tiled = ref.scene_from_meshes(out["meshes"], True, "cpu")
    assert tiled.num_triangles >= ref.CULL_FROM and tiled.tile_lo is not None
    brute = ref.RefScene(tiled.v0, tiled.e1, tiled.e2, tiled.normal,
                         tiled.material, tiled.velocity)
    g = torch.Generator().manual_seed(1)
    R = 2000
    o = ((torch.rand(R, 3, generator=g) - 0.5)
         * torch.tensor([300.0, 300.0, 80.0]) + torch.tensor([0, 0, 30.0]))
    d = torch.randn(R, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    d[:50, 2] = 0.0                       # rays parallel to a slab
    args = dict(
        none={}, exclude=dict(exclude=torch.randint(
            -1, tiled.num_triangles, (R,), generator=g)),
        all=dict(exclude=torch.randint(-1, tiled.num_triangles, (R,),
                                       generator=g),
                 t_max=torch.rand(R, generator=g) * 200,
                 live=torch.rand(R, generator=g) > 0.1))[kw]
    t_a, i_a = ref.nearest_hit(tiled, o, d, **args)
    t_b, i_b = ref.nearest_hit(brute, o, d, **args)
    assert int((i_b >= 0).sum()) > 100
    assert torch.equal(i_a, i_b) and torch.equal(t_a, t_b)
