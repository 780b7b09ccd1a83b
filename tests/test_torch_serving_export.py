"""Serving export: twins of tests/test_serving.py's seven cases on the port
(``export_sampler``, ``Sampler``, ``export_encoder``, ``Encoder`` over
``torch.export``), the latent draw split (``latent_draws`` and
``latent_from_draws`` compose to ``latent_sample`` bit for bit), the
registered ``sdeflow`` operators under ``torch.library.opcheck``, and a
fresh process that loads an artifact without the model or SDE modules.

A served program runs the ops of the eager one on the same draws, so it
is held to equality (max |Δ| = 0) where the JAX twins allow 1e-3; the
encoder's decode to 5e-3 as in JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.data.synthetic import SwissRoll
from sdeflow_tpu_torch.models.mlp import MLP
from sdeflow_tpu_torch.ops.hutchinson import randu_on_sphere
from sdeflow_tpu_torch.ops.kde import gaussian_kde_sample
from sdeflow_tpu_torch.ops.kernels.attention import attention_reference
from sdeflow_tpu_torch.ops.kernels.attnblock import attn_block_math
from sdeflow_tpu_torch.ops.kernels.groupnorm import gn_math
from sdeflow_tpu_torch.ops.ode import encode_ode, integrate_ode
from sdeflow_tpu_torch.sde import MSGMSde, PluginReverseSDE, SGMSde
from sdeflow_tpu_torch.serving import (
    Encoder, Sampler, export_encoder, export_sampler, make_sampler_fn)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# the encoder's RK4 steps, the JAX twin's
STEPS_ENC = 32


def _gen(seed=0, dtype=torch.float32):
    torch.manual_seed(seed)
    return PluginReverseSDE.create(
        SGMSde.create(num_steps_forward=8, device="cpu"),
        MLP(input_dim=2, dtype=dtype))


def _msgm_gen(n=2000, seed=1):
    g = torch.Generator().manual_seed(seed)
    x_init = 2.0 * torch.randn((n, 4), generator=g)
    sde = MSGMSde.create(x_init, num_steps_forward=8, norm_map="log",
                         dense_tensor=False)
    torch.manual_seed(seed)
    net = MLP(input_dim=4, premodule="NormalizeLogRadius")
    return PluginReverseSDE.create(sde, net), x_init


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _eager(gen, served, seed, n, dim, steps, **kw):
    """The eager program on the served program's draws."""
    draws = served.draws(_g(seed), n)
    specs = served.meta["inputs"]
    n_lat = sum(s["name"] not in ("noise", "corrector_noise") for s in specs)
    rest = {s["name"]: d for s, d in zip(specs[n_lat:], draws[n_lat:])}
    x0 = gen.base_sde.latent_from_draws(*draws[:n_lat])
    return make_sampler_fn(gen, n, dim, steps, device="cpu", **kw)(
        None, x0=x0, **rest)


def test_export_roundtrip_matches_inprocess(tmp_path):
    gen = _gen()
    path = str(tmp_path / "model.sdeflow")
    meta = export_sampler(gen, path, num_samples=64, dim=2, num_steps=16)
    assert meta["num_samples"] == 64
    assert [s["name"] for s in meta["inputs"]] == ["z", "noise"]
    served = Sampler(path)
    out = served(_g(7))
    assert out.shape == (64, 2)
    assert torch.equal(out, _eager(gen, served, 7, 64, 2, 16))
    # deterministic per seed, different across seeds
    assert torch.equal(served(_g(7)), out)
    assert not torch.allclose(served(_g(8)), out)


def test_exported_artifact_is_self_contained(tmp_path):
    """The serving handle needs only the artifact and its sidecar; what
    cannot be staged raises."""
    gen = _gen()
    path = str(tmp_path / "standalone.sdeflow")
    export_sampler(gen, path, num_samples=16, dim=2, num_steps=4)
    del gen
    s = Sampler(path)
    out = s(_g(0))
    assert out.shape == (16, 2) and bool(torch.isfinite(out).all())
    assert s.meta["method"] == "rk4"
    with open(path + ".json") as f:
        assert json.load(f)["inputs"][1]["shape"] == [4, 16, 2]
    with pytest.raises(NotImplementedError, match="dopri"):
        export_sampler(_gen(), path, 16, 2, 4, sampler="ode",
                       method="dopri")
    pot = _gen()
    pot.score_net.learn_potential = True
    with pytest.raises(NotImplementedError, match="potential"):
        export_sampler(pot, path, 16, 2, 4)


def test_export_msgm_norm_corrected_sampler(tmp_path):
    """The MSGM program (radial latent prior, norm-corrected RK4) exports
    and serves: the radii of served samples follow the training norms."""
    gen, x_init = _msgm_gen()
    path = str(tmp_path / "msgm.sdeflow")
    export_sampler(gen, path, num_samples=256, dim=4, num_steps=8,
                   norm_correction=True)
    served = Sampler(path)
    out = served(_g(5))
    assert out.shape == (256, 4)
    assert torch.equal(out, _eager(gen, served, 5, 256, 4, 8,
                                   norm_correction=True))
    r = np.linalg.norm(out.numpy(), axis=1)
    r_data = np.linalg.norm(x_init.numpy(), axis=1)
    assert abs(np.median(r) - np.median(r_data)) < 0.3


def test_polymorphic_batch_export(tmp_path):
    """One artifact, any batch: the symbolic-batch program serves 64 and
    256, matches the fixed-batch artifact at its own batch, and the fixed
    artifact refuses other batches."""
    gen = _gen()
    fixed, poly = str(tmp_path / "fixed.sdeflow"), str(tmp_path / "p.sdeflow")
    export_sampler(gen, fixed, num_samples=64, dim=2, num_steps=8)
    meta = export_sampler(gen, poly, num_samples=64, dim=2, num_steps=8,
                          polymorphic_batch=True)
    assert meta["polymorphic_batch"] is True
    s_poly, s_fixed = Sampler(poly), Sampler(fixed)
    out64 = s_poly(_g(11))  # the recorded default batch
    out256 = s_poly(_g(11), num_samples=256)
    assert out64.shape == (64, 2) and out256.shape == (256, 2)
    assert bool(torch.isfinite(out256).all())
    assert torch.equal(out64, s_fixed(_g(11)))
    with pytest.raises(ValueError, match="polymorphic_batch=True"):
        s_fixed(_g(11), num_samples=256)


def test_polymorphic_batch_msgm_kde_and_dpm(tmp_path):
    """The symbolic batch traces through the MSGM radial prior (here the
    KDE sampler: a randint and a normal draw) and the dpm2m integrator."""
    g = _g(1)
    x_init = 2.0 * torch.randn((500, 4), generator=g)
    sde = MSGMSde.create(x_init, num_steps_forward=4, norm_map="log",
                         norm_sampler="kde", dense_tensor=False)
    gen_m = PluginReverseSDE.create(
        sde, MLP(input_dim=4, premodule="NormalizeLogRadius"))
    path_m = str(tmp_path / "msgm_poly.sdeflow")
    meta = export_sampler(gen_m, path_m, num_samples=32, dim=4, num_steps=4,
                          norm_correction=True, polymorphic_batch=True)
    assert [s["law"] for s in meta["inputs"]] == [
        "randint", "normal", "normal", "normal"]
    served = Sampler(path_m)
    out = served(_g(2), num_samples=96)
    assert out.shape == (96, 4) and bool(torch.isfinite(out).all())
    assert torch.equal(out, _eager(gen_m, served, 2, 96, 4, 4,
                                   norm_correction=True))

    path_d = str(tmp_path / "dpm_poly.sdeflow")
    export_sampler(_gen(), path_d, num_samples=32, dim=2, num_steps=8,
                   sampler="dpm", method="dpm2m", polymorphic_batch=True)
    out = Sampler(path_d)(_g(3), num_samples=128)
    assert out.shape == (128, 2) and bool(torch.isfinite(out).all())


def test_export_encoder_roundtrip(tmp_path):
    """The exported encoder equals in-process encode_ode; the polymorphic
    artifact serves any batch; decoding inverts it."""
    gen = _gen()
    x = torch.randn((16, 2), generator=_g(0))
    path = str(tmp_path / "m.encoder")
    meta = export_encoder(gen, path, 16, 2, STEPS_ENC)
    assert meta["kind"] == "encoder" and not meta["polymorphic_batch"]
    enc = Encoder(path)
    with torch.no_grad():
        assert torch.equal(enc(x), encode_ode(gen, x, STEPS_ENC))
    with pytest.raises(ValueError):
        enc(x[:8])
    ppath = str(tmp_path / "m_poly.encoder")
    export_encoder(gen, ppath, 16, 2, STEPS_ENC, polymorphic_batch=True)
    enc_p = Encoder(ppath)
    for b in (4, 16, 33):
        xb = torch.randn((b, 2), generator=_g(b))
        z = enc_p(xb)
        assert z.shape == (b, 2)
        with torch.no_grad():
            np.testing.assert_allclose(
                integrate_ode(gen, z, STEPS_ENC).numpy(), xb.numpy(),
                atol=5e-3, rtol=0)


def test_export_bf16_net_pc_sampler(tmp_path):
    """A bfloat16 compute-dtype score net exports and serves with the
    production knobs (EM plus one Langevin corrector step): the bf16 casts
    are in the program, the outputs stay fp32, and the artifact reproduces
    the eager program on the same draws."""
    gen = _gen(dtype=torch.bfloat16)
    path = str(tmp_path / "model_bf16.sdeflow")
    kw = dict(method="em", corrector_steps=1)
    meta = export_sampler(gen, path, num_samples=64, dim=2, num_steps=16,
                          **kw)
    assert [s["name"] for s in meta["inputs"]] == [
        "z", "noise", "corrector_noise"]
    served = Sampler(path)
    out = served(_g(7))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert torch.equal(out, _eager(gen, served, 7, 64, 2, 16, **kw))


def _old_msgm_latent(sde, generator, n):
    """latent_sample as it was written before the draw split."""
    if sde.norm_sampler == "ecdf":
        r = sde.radii_from_uniform(torch.rand(
            (n,), generator=generator, dtype=sde.r_T.dtype))
    else:
        r = gaussian_kde_sample(generator, sde.r_T, sde.kde_bandwidth, n)
        r = (torch.exp(r) - 1e-6 if sde.norm_map == "log"
             else torch.clamp(r, min=0.0))[:, None]
    return r * randu_on_sphere(generator, (n, sde.dim), device="cpu")


@pytest.mark.parametrize("kind", ["sgm", "ecdf", "kde"])
def test_latent_sample_is_its_draws_composed(kind):
    if kind == "sgm":
        sde = SGMSde.create(device="cpu")
        old = torch.randn((33, 6), generator=_g(4))
    else:
        x = 2.0 * torch.randn((100, 6), generator=_g(2))
        sde = MSGMSde.create(x, norm_sampler=kind, dense_tensor=False,
                             norm_map="log" if kind == "kde" else None)
        old = _old_msgm_latent(sde, _g(4), 33)
    new = sde.latent_sample(_g(4), 33, 6)
    split = sde.latent_from_draws(*sde.latent_draws(_g(4), 33, 6))
    assert torch.equal(new, old) and torch.equal(split, old)
    specs = sde.latent_draw_specs(33, 6)
    assert [list(d.shape) for d in sde.latent_draws(_g(4), 33, 6)] == [
        s["shape"] for s in specs]


def _op_cases(kind, dtype):
    g = _g(9)
    if kind == "circulant_apply":
        y = torch.randn(4, 64, generator=g)
        return (torch.rand(4, 1, generator=g), y, torch.randn(4, 64,
                                                              generator=g))
    if kind == "group_norm_silu":
        return (torch.randn(2, 8, 5, generator=g).to(dtype),
                torch.randn(8, generator=g), torch.randn(8, generator=g), 4,
                True)
    if kind == "attn_block":
        c = 16
        ws = [torch.randn(s, generator=g) / 4 for s in (
            (c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,))]
        return (torch.randn(2, 9, c, generator=g).to(dtype), *ws, 8, 2)
    return (torch.randn(2, 9, 48, generator=g).to(dtype), 2)


PLAIN = {"circulant_apply": None, "group_norm_silu": gn_math,
         "attn_block": attn_block_math, "qkv_attention": attention_reference}


@pytest.mark.parametrize("kind", sorted(PLAIN))
def test_registered_operators_pass_opcheck(kind):
    """Each sdeflow operator: schema, fake impl, dispatch and the CPU impl
    equal to its plain version, in float32 and bfloat16."""
    op = getattr(torch.ops.sdeflow, kind).default
    dtypes = ((torch.float32,) if kind == "circulant_apply"
              else (torch.float32, torch.bfloat16))
    for dt in dtypes:
        args = _op_cases(kind, dt)
        torch.library.opcheck(op, args)
        if PLAIN[kind] is not None:
            assert torch.equal(op(*args), PLAIN[kind](*args))


_FRESH = r"""
import json, sys
import torch
from sdeflow_tpu_torch.serving import Sampler
s = Sampler(sys.argv[1])
out = s(torch.Generator().manual_seed(3))
bad = sorted(m for m in sys.modules if m.startswith(
    ("sdeflow_tpu_torch.models", "sdeflow_tpu_torch.sde")))
print(json.dumps(dict(bad=bad, sum=float(out.double().sum()),
                      shape=list(out.shape))))
"""


def test_fresh_process_loads_without_the_model_modules(tmp_path):
    gen, _ = _msgm_gen(n=300)
    path = str(tmp_path / "fresh.sdeflow")
    export_sampler(gen, path, num_samples=32, dim=4, num_steps=4,
                   norm_correction=True)
    want = Sampler(path)(_g(3))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _FRESH, path], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["shape"] == [32, 4]
    assert got["sum"] == float(want.double().sum())
