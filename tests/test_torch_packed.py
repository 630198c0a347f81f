"""The port's packed march, packed compositing and reference renderers
against the JAX package (ops/marching.py, ops/composite.py,
render/renderer.py).

Seeded numpy inputs go through both packages; fields carry their weights
across (params_from_jax). Tolerances:
- candidate_ts: equal at dt_gamma = 0 (the same closed form); at dt_gamma >
  0 the port's closed-form ladder against the reference's 1024-step scan
  within rtol 5e-6 (the scan's f32 sums accumulate their rounding over up
  to 1024 steps: measured 2.6e-6 at bounds 1 to 8), the steps within 1e-6;
- occupancy_at and march_rays (ray ids, valid slots, counts, totals, the
  budget drop at a small budget): equal; the packed positions, ts and
  steps within 1e-5, or rtol 5e-6 of the far ts of the ladder;
- composite_packed: rtol 1e-5, atol 1e-6 (the port's optical depth is an
  f64 segmented sum, the reference's an f32 global cumsum less the segment
  bases; over 2^20 samples the port's stays within 1e-6 of an exact
  per-ray sum); with one infinite or NaN sigma the other rays' outputs
  stay finite and within 1e-7 of the all-finite batch's, and with +inf the
  gradient is finite and within 1e-6 of the all-finite one off that ray
  (C8);
- render_occ over the narrow Instant-NGP field (with and without the
  background sphere) and over a narrow CP field: image and depth within
  2e-3 (the same bf16 rounding points, f32 sums in other orders); the
  parameter gradients of an MSE per leaf within 5e-2 in relative L2 norm
  (measured up to 2.8e-2, on the background's table: there the
  reference's own gradient moves by 4.4 % of its largest entry when the
  params move by one part in 1e6, as bf16 roundings and relu masks flip);
- render_uniform within 2e-3; sample_pdf(det=True) within rtol 1e-5,
  atol 1e-5.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models.api import make_ngp_field as jax_ngp_field
from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig
from sealdnerf_tpu.models.cp import make_cp_field as jax_cp_field
from sealdnerf_tpu.models.ngp import NGPConfig as JaxNGPConfig
from sealdnerf_tpu.ops.ray import near_far_from_aabb as jax_near_far
from sealdnerf_tpu.render import renderer as jr
from sealdnerf_tpu_torch.models.api import make_ngp_field
from sealdnerf_tpu_torch.models.cp import CPConfig, CPField
from sealdnerf_tpu_torch.models.ngp import NGPConfig
from sealdnerf_tpu_torch.models.params import param_leaves, params_from_jax
from sealdnerf_tpu_torch.ops.composite import composite_packed
from sealdnerf_tpu_torch.ops.field import field_train_forward
from sealdnerf_tpu_torch.render import renderer as tr

jm = importlib.import_module("sealdnerf_tpu.ops.marching")
jc = importlib.import_module("sealdnerf_tpu.ops.composite")
tm = importlib.import_module("sealdnerf_tpu_torch.ops.marching")

NGP_NARROW = dict(num_levels=4, log2_hashmap_size=12)
CP_NARROW = dict(scales=((16, 8), (64, 16)), planes=((16, 4),))
FRAME_TOL = 2e-3
GRAD_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(bound, dt_gamma, grid=16, steps=1024):
    cas = 1 + max(0, int(np.ceil(np.log2(max(bound, 1.0)))))
    kw = dict(bound=bound, cascades=cas, grid_size=grid, dt_gamma=dt_gamma,
              max_steps=steps)
    return jm.MarchConfig(**kw), tm.MarchConfig(**kw)


def _rays(n, bound, seed=0):
    """Rays from a sphere of radius 2.5 * bound towards the box, jittered."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5 * bound
    d = -o + rng.normal(size=(n, 3)) * 0.4 * bound
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _occ(cas, h, share=0.3, seed=1):
    """A blob of occupied cells around the centre plus random ones."""
    rng = np.random.default_rng(seed)
    c = (np.arange(h) + 0.5) / h * 2 - 1
    r = np.sqrt(sum(np.meshgrid(c * c, c * c, c * c, indexing="ij")))
    occ = (r < 0.6)[None] | (rng.uniform(size=(cas, h, h, h)) < share)
    return np.broadcast_to(occ, (cas, h, h, h)).copy()


@pytest.mark.parametrize("dt_gamma", [0.0, 1.0 / 128])
@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_candidate_ts_matches_the_scan(bound, dt_gamma):
    jcfg, tcfg = _cfgs(bound, dt_gamma, grid=128)
    rng = np.random.default_rng(2)
    nears = rng.uniform(0.2, 4 * bound, 256).astype(np.float32)
    noise = rng.uniform(0, 1, 256).astype(np.float32)
    for nz in (None, noise):
        ts_j, dt_j = jm.candidate_ts(jnp.asarray(nears), jcfg,
                                     None if nz is None else jnp.asarray(nz))
        ts_t, dt_t = tm.candidate_ts(_t(nears), tcfg,
                                     None if nz is None else _t(nz))
        assert ts_t.shape == (256, 1024)
        if dt_gamma == 0.0:
            np.testing.assert_array_equal(ts_t.numpy(), np.asarray(ts_j))
            np.testing.assert_array_equal(dt_t.numpy(), np.asarray(dt_j))
        else:
            np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j),
                                       rtol=5e-6, atol=0)
            np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_occupancy_at_matches(bound):
    jcfg, tcfg = _cfgs(bound, 1.0 / 128)
    rng = np.random.default_rng(3)
    occ = _occ(jcfg.cascades, 16)
    xyz = rng.uniform(-bound, bound, (4096, 3)).astype(np.float32)
    dts = rng.uniform(0.001, 0.2, 4096).astype(np.float32)
    got = tm.occupancy_at(_t(xyz), _t(dts), _t(occ), tcfg)
    ref = jm.occupancy_at(jnp.asarray(xyz), jnp.asarray(dts),
                          jnp.asarray(occ), jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < float(got.float().mean()) < 0.95


@pytest.mark.parametrize("budget", ["ample", "small"])
@pytest.mark.parametrize("dt_gamma", [0.0, 1.0 / 128])
@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_march_rays_matches(bound, dt_gamma, budget):
    jcfg, tcfg = _cfgs(bound, dt_gamma, steps=512)
    ro, rd = _rays(96, bound)
    occ = _occ(jcfg.cascades, 16)
    aabb = np.array([-bound] * 3 + [bound] * 3, np.float32)
    n, f = jax_near_far(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(aabb),
                        0.2)
    noise = np.random.default_rng(4).uniform(0, 1, 96).astype(np.float32)
    m = 96 * 512 if budget == "ample" else 700
    pj = jm.march_rays(jnp.asarray(ro), jnp.asarray(rd), n, f,
                       jnp.asarray(occ), jcfg, m, noise=jnp.asarray(noise))
    pt = tm.march_rays(_t(ro), _t(rd), _t(n), _t(f), _t(occ), tcfg, m,
                       noise=_t(noise))
    total = int(pt["total"])
    assert total == int(pj["total"]) and total > 1000
    if budget == "small":
        assert total > m            # the budget drops samples
    for k in ("ray_id", "valid", "counts"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    assert int(pt["counts"].sum()) == min(total, m)
    for k in ("xyzs", "ts", "dts", "dirs"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=5e-6, atol=1e-5)


def test_composite_packed_matches():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 40, 64)
    m = int(counts.sum()) + 17                   # padding slots
    ray_id = np.concatenate([np.repeat(np.arange(64), counts),
                             np.full(17, 63)]).astype(np.int32)
    valid = np.arange(m) < counts.sum()
    sig = rng.exponential(3.0, m).astype(np.float32)
    rgb = rng.uniform(size=(m, 3)).astype(np.float32)
    dts = rng.uniform(0.005, 0.05, m).astype(np.float32)
    ts = np.cumsum(dts).astype(np.float32)
    ref = jc.composite_packed(*map(jnp.asarray, (sig, rgb, dts, ts, ray_id,
                                                 valid)), n_rays=64)
    got = composite_packed(_t(sig), _t(rgb), _t(dts), _t(ts),
                           _t(ray_id.astype(np.int64)), _t(valid), 64)
    for k in ("weights", "weights_sum", "depth", "image"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)


def test_composite_packed_segments_are_exact():
    """2^20 samples over 2^14 rays: the weights against a per-ray f64
    transmittance."""
    rng = np.random.default_rng(6)
    n, per = 1 << 14, 64
    sig = rng.exponential(2.0, n * per).astype(np.float32)
    dts = np.full(n * per, 0.02, np.float32)
    ray_id = np.repeat(np.arange(n), per)
    got = composite_packed(_t(sig), torch.ones(n * per, 3), _t(dts),
                           _t(dts), _t(ray_id), torch.ones(n * per,
                                                           dtype=torch.bool),
                           n, t_thresh=0.0)["weights"].numpy()
    sdt = (sig.astype(np.float64) * dts).reshape(n, per)
    od = np.cumsum(sdt, 1) - sdt
    exact = (1 - np.exp(-sdt)) * np.exp(-od)
    np.testing.assert_allclose(got, exact.reshape(-1), rtol=0, atol=1e-6)


def _sixteen_rays(seed=7):
    """16 rays of 3-20 samples each, with 5 padding slots at the end."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(3, 21, 16)
    m = int(counts.sum()) + 5
    ray_id = np.concatenate([np.repeat(np.arange(16), counts),
                             np.full(5, 15)])
    valid = np.arange(m) < counts.sum()
    sig = rng.exponential(3.0, m).astype(np.float32)
    rgb = rng.uniform(size=(m, 3)).astype(np.float32)
    dts = rng.uniform(0.005, 0.05, m).astype(np.float32)
    ts = np.cumsum(dts).astype(np.float32)
    # the poisoned sample: the middle one of ray 3
    poison = int(counts[:3].sum() + counts[3] // 2)
    return sig, rgb, dts, ts, ray_id, valid, poison


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_composite_packed_non_finite_sigma_stays_in_its_ray(bad):
    """C8: one infinite (or NaN) sigma in ray 3 of 16 leaves every other
    ray finite and within 1e-7 of the all-finite result (the later rays'
    f64 sums round apart by the poisoned ray's share); the reference's global
    cumsum loses every later ray (inf - inf = NaN). The all-finite
    batch agrees with the reference as test_composite_packed_matches
    holds it (rtol 1e-5, atol 1e-6: the reference's f32 global cumsum is
    the less exact of the two)."""
    sig, rgb, dts, ts, ray_id, valid, poison = _sixteen_rays()
    args = (_t(rgb), _t(dts), _t(ts), _t(ray_id), _t(valid), 16)
    clean = composite_packed(_t(sig), *args)
    ref = jc.composite_packed(*map(jnp.asarray, (sig, rgb, dts, ts,
                                                 ray_id.astype(np.int32),
                                                 valid)), n_rays=16)
    for k in ("weights", "weights_sum", "depth", "image"):
        np.testing.assert_allclose(clean[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)
    sig_bad = sig.copy()
    sig_bad[poison] = bad
    got = composite_packed(_t(sig_bad), *args)
    others = np.arange(16) != 3
    for k in ("weights_sum", "depth", "image"):
        g, c = got[k].numpy()[others], clean[k].numpy()[others]
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-7)
    off = ray_id != 3
    assert np.isfinite(got["weights"].numpy()[off]).all()
    np.testing.assert_allclose(got["weights"].numpy()[off],
                               clean["weights"].numpy()[off], rtol=0,
                               atol=1e-7)
    # the reference's batch loses the rays past the poisoned one (NaN
    # transmittance: blank or NaN)
    ref_bad = jc.composite_packed(*map(jnp.asarray, (
        sig_bad, rgb, dts, ts, ray_id.astype(np.int32), valid)), n_rays=16)
    lost = ~np.isclose(np.asarray(ref_bad["weights_sum"])[4:],
                       clean["weights_sum"].numpy()[4:], atol=1e-3)
    assert lost.all()


def test_composite_packed_gradient_with_an_infinite_sigma():
    """C8's backward: with +inf in ray 3, the gradient of every output's
    sum w.r.t. sigma is finite, and off ray 3 within rtol 1e-6, atol 1e-7
    of the all-finite gradient (a ray's outputs depend on its own samples
    only)."""
    sig, rgb, dts, ts, ray_id, valid, poison = _sixteen_rays(8)
    args = (_t(rgb), _t(dts), _t(ts), _t(ray_id), _t(valid), 16)

    def grad(s):
        s = _t(s).requires_grad_(True)
        out = composite_packed(s, *args)
        (out["image"].sum() + out["depth"].sum()
         + out["weights_sum"].sum()).backward()
        return s.grad.numpy()
    g_clean = grad(sig)
    sig_bad = sig.copy()
    sig_bad[poison] = np.inf
    g_bad = grad(sig_bad)
    assert np.isfinite(g_bad).all()
    off = ray_id != 3
    np.testing.assert_allclose(g_bad[off], g_clean[off], rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------------- renderers
def _ngp_fields(bound, bg_radius):
    jcfg = JaxNGPConfig(bound=bound, bg_radius=bg_radius, **NGP_NARROW)
    jf = jax_ngp_field(jax.random.PRNGKey(0), jcfg)
    # tables of U(-1, 1), so that the field varies over the box
    params = jax.tree_util.tree_map(np.asarray, jf.params)
    params = {k: (v * 1e4 if "grid" in k else v) for k, v in params.items()}
    tf = make_ngp_field(torch.Generator().manual_seed(0), NGPConfig(
        bound=bound, bg_radius=bg_radius, **NGP_NARROW))
    tf.params = params_from_jax(params)
    return jf, tf, params


def _cp_fields():
    jf = jax_cp_field(jax.random.PRNGKey(0), JaxCPConfig(**CP_NARROW))
    params = jax.tree_util.tree_map(np.asarray, jf.params)
    cfg = CPConfig(**CP_NARROW)
    field = CPField(params_from_jax(params), cfg)

    def forward(p, x, d):
        out = field_train_forward(p, cfg, x.t().contiguous(),
                                  d.t().contiguous())
        return out[0], out[1:4].t()
    field.forward, field.background = forward, None
    return jf, field, params


def _grad_errs(got, ref):
    """Per leaf: |got - ref|_2 / |ref|_2."""
    return [float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30))
            for g, r in zip(got, ref)]


@pytest.mark.parametrize("case", ["ngp", "ngp_bg", "cp"])
def test_render_occ_matches(case):
    bound = 1.0 if case == "cp" else 2.0
    bg_radius = 4.0 if case == "ngp_bg" else -1.0
    jf, tf, params = _cp_fields() if case == "cp" else \
        _ngp_fields(bound, bg_radius)
    jcfg, tcfg = _cfgs(bound, 1.0 / 128, steps=512)
    js = jr.RenderSettings(march=jcfg, bg_radius=bg_radius,
                           samples_per_ray=48)
    ts = tr.RenderSettings(march=tcfg, bg_radius=bg_radius,
                           samples_per_ray=48)
    ro, rd = _rays(128, bound, seed=7)
    occ = _occ(jcfg.cascades, 16)
    rng = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.uniform(rng, (128,)))
    gt = np.random.default_rng(8).uniform(size=(128, 3)).astype(np.float32)

    def jloss(p):
        res = jr.render_occ(p, jnp.asarray(occ), jnp.asarray(ro),
                            jnp.asarray(rd), js, jf.forward, jf.background,
                            rng=rng, perturb=True)
        return jnp.mean((res["image"] - gt) ** 2), res

    (lj, res_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = tf.params
    for leaf in param_leaves(tp):
        leaf.requires_grad_(True)
    res_t = tr.render_occ(tp, _t(occ), _t(ro), _t(rd), ts, tf.forward,
                          tf.background, perturb=True, noise=_t(noise))
    lt = torch.mean((res_t["image"] - _t(gt)) ** 2)
    g_t = torch.autograd.grad(lt, param_leaves(tp))
    assert int(res_t["n_samples"]) == int(res_j["n_samples"])
    assert float(res_t["weights_sum"].max()) > 0.3
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(res_t[k].detach().numpy(),
                                   np.asarray(res_j[k]), rtol=0,
                                   atol=FRAME_TOL * (2 * bound if k == "depth"
                                                     else 1))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)
    errs = _grad_errs([g.numpy() for g in g_t],
                      [np.asarray(g) for g in jax.tree_util.tree_leaves(g_j)])
    print(case, "grad errors", [round(e, 4) for e in errs])
    assert max(errs) <= GRAD_TOL, errs


def test_render_uniform_and_sample_pdf_match():
    jf, tf, params = _ngp_fields(1.0, -1.0)
    jcfg, tcfg = _cfgs(1.0, 0.0)
    js = jr.RenderSettings(march=jcfg, num_steps=32, upsample_steps=32)
    ts = tr.RenderSettings(march=tcfg, num_steps=32, upsample_steps=32)
    ro, rd = _rays(64, 1.0, seed=9)
    res_j = jr.render_uniform(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(ro), jnp.asarray(rd), js,
                              jf.density, jf.color)
    with torch.no_grad():
        res_t = tr.render_uniform(tf.params, _t(ro), _t(rd), ts, tf.density,
                                  tf.color)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(res_t[k].numpy(), np.asarray(res_j[k]),
                                   rtol=0, atol=FRAME_TOL)
    rng = np.random.default_rng(10)
    bins = np.sort(rng.uniform(0, 4, (64, 33)), 1).astype(np.float32)
    w = rng.exponential(1.0, (64, 32)).astype(np.float32)
    ref = jr.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 48,
                        det=True)
    got = tr.sample_pdf(_t(bins), _t(w), 48, det=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
