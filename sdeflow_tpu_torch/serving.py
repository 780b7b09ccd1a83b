"""Serving: the sampling program, and its export for a serving host.

Port of sdeflow_tpu/serving.py. ``make_sampler_fn`` and ``_solve_from``
(:27-82): a latent draw, then one reverse solve with the score net inside
it, under ``torch.no_grad()`` (sampling records no graph): the reverse
SDE (``sampler="sde"``, with ``corrector_steps`` Langevin corrector steps
after each predictor step when asked: predictor–corrector sampling), the
probability-flow ODE (``"ode"``, ``ops/ode.py``: deterministic, the
generator seeds only the latent draw) or a DPM-Solver exponential
integrator (``"dpm"``, ``ops/expint.py``, SGM only: deterministic but for
the stochastic sdpm methods).

``export_sampler`` and ``export_encoder`` (:85-206) stage the whole
program, the latent transform and the solve with the score net baked in,
with ``torch.export`` and save it with ``torch.export.save``, beside a
``.json`` sidecar. A ``torch.Generator`` cannot be an input of an exported
program, so the sampler's inputs are its raw draws, whose shapes and laws
the sidecar records: the latent's (the base SDE's ``latent_draws``), the
predictor's standard normals ``noise`` (num_steps, B, d) and the
corrector's ``corrector_noise`` (num_steps, corrector_steps, B, d).
``Sampler(path)(generator)`` makes those draws from the caller's generator
and runs the loaded program; ``Encoder(path)(x)`` runs the exported
PF-ODE encoder. The kernels of the program are the ``sdeflow`` operators
(ops/kernels/common.py ``register_op``), so a loaded program launches the
same CUDA kernels, counted as in eager; ``Sampler`` and ``Encoder`` need
torch and the modules that register those operators, not ``models`` or
``sde``. ``polymorphic_batch`` exports a symbolic batch
(``torch.export.Dim``): one artifact serves any batch of at least 2.
"""

from __future__ import annotations

import contextlib
import json
import os
import typing

import torch

# the sdeflow operators that an exported program calls
from sdeflow_tpu_torch.ops.kernels import attnblock, circulant  # noqa: F401
from sdeflow_tpu_torch.ops.expint import dpm_schedule, integrate_dpm
from sdeflow_tpu_torch.ops.integrators import integrate_sde
from sdeflow_tpu_torch.ops.kernels.common import resolve_device
from sdeflow_tpu_torch.ops.ode import encode_ode, integrate_ode

SAMPLERS = ("sde", "ode", "dpm")
# the smallest batch a symbolic-batch artifact serves
MIN_BATCH = 2


def make_sampler_fn(gen_sde, num_samples, dim, num_steps, *, method="rk4",
                    lmbd=0.0, norm_correction=False, keep_all=False,
                    include_t0=False, sampler="sde", corrector_steps=0,
                    snr=0.16, dpm_grid="logsnr", device="cuda"):
    """Close the generative program over a PluginReverseSDE:
    ``sample(generator, x0=None, noise=None, corrector_noise=None) ->
    (num_samples, dim)`` samples (or the trajectory with keep_all). x0
    replaces the latent draw, noise (num_steps, num_samples, dim) the
    solve's standard normal draws (the SDE's predictor, the sdpm methods),
    corrector_noise (num_steps, corrector_steps, num_samples, dim) the
    corrector's. sampler: "sde" (method em, heun or rk4; corrector_steps
    Langevin steps with snr after each predictor step,
    ``ops/integrators.integrate_sde``), "ode" (method euler, heun, rk4 or
    dopri) or "dpm" (method dpm1, dpm2, dpm2m, dpm3m, sdpm1 or sdpm2m,
    dpm2m for any other name; dpm_grid logsnr, time or karras)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} (sde|ode|dpm)")
    device = resolve_device(device)

    @torch.no_grad()
    def sample(generator, x0=None, noise=None, corrector_noise=None):
        if x0 is None:
            x0 = gen_sde.latent_sample(generator, num_samples, dim)
        if x0.device.type != device.type or tuple(x0.shape) != (num_samples,
                                                                  dim):
            raise ValueError(f"x0 {tuple(x0.shape)} on {x0.device}, expected "
                             f"{(num_samples, dim)} on {device}")
        return _solve_from(
            gen_sde, x0, generator, num_steps, method=method, lmbd=lmbd,
            norm_correction=norm_correction, keep_all=keep_all,
            include_t0=include_t0, sampler=sampler,
            corrector_steps=corrector_steps, snr=snr, dpm_grid=dpm_grid,
            noise=noise, corrector_noise=corrector_noise)

    return sample


def _dpm_method(method):
    return method if method.startswith(("dpm", "sdpm")) else "dpm2m"


def _solve_from(gen_sde, x0, generator, num_steps, *, method, lmbd,
                norm_correction, keep_all, include_t0, sampler,
                corrector_steps, snr, dpm_grid="logsnr", noise=None,
                corrector_noise=None):
    """One reverse solve from the latents x0 by `sampler`."""
    if sampler == "dpm":
        m = _dpm_method(method)
        stochastic = m.startswith("sdpm")
        return integrate_dpm(
            gen_sde, x0, num_steps, method=m, grid=dpm_grid,
            keep_all=keep_all, include_t0=include_t0,
            generator=generator if stochastic else None,
            noise=noise if stochastic else None)
    if sampler == "ode":
        return integrate_ode(
            gen_sde, x0, num_steps, method=method,
            norm_correction=norm_correction, keep_all=keep_all,
            include_t0=include_t0)
    return integrate_sde(
        gen_sde, x0, generator, num_steps, method=method, lmbd=lmbd,
        norm_correction=norm_correction, keep_all=keep_all,
        include_t0=include_t0, noise=noise,
        corrector_steps=corrector_steps, snr=snr,
        corrector_noise=corrector_noise)


# -- export -------------------------------------------------------------------


def _input_specs(gen_sde, num_samples, dim, num_steps, *, sampler="sde",
                method="rk4", corrector_steps=0):
    """The exported sampler's inputs in order: the latent's raw draws
    (``latent_draw_specs`` of the base SDE), then the predictor's
    ``noise`` where the sampler is stochastic, then ``corrector_noise``.
    Each is a dict of name, law (normal, uniform, randint with ``high``),
    shape and ``batch_axis``."""
    specs = [dict(s, batch_axis=0) for s in
             gen_sde.base_sde.latent_draw_specs(num_samples, dim)]
    if sampler == "sde" or (sampler == "dpm"
                            and _dpm_method(method).startswith("sdpm")):
        specs.append(dict(name="noise", law="normal",
                          shape=[num_steps, num_samples, dim], batch_axis=1))
    if sampler == "sde" and corrector_steps:
        specs.append(dict(name="corrector_noise", law="normal",
                          shape=[num_steps, corrector_steps, num_samples,
                                 dim], batch_axis=2))
    return specs


def make_draws(specs, generator, num_samples=None):
    """The inputs of ``specs`` drawn from `generator`, on its device, in
    order; num_samples, if given, replaces each batch axis."""
    out = []
    for s in specs:
        shape = list(s["shape"])
        if num_samples is not None:
            shape[s["batch_axis"]] = int(num_samples)
        kw = dict(generator=generator, device=generator.device)
        if s["law"] == "normal":
            out.append(torch.randn(shape, **kw))
        elif s["law"] == "uniform":
            out.append(torch.rand(shape, **kw))
        elif s["law"] == "randint":
            out.append(torch.randint(0, int(s["high"]), shape, **kw))
        else:
            raise ValueError(f"unknown law {s['law']!r}")
    return out


class _Program(torch.nn.Module):
    """The function to export, as a module that holds the score net (so
    that its parameters are the program's)."""

    def __init__(self, fn, net):
        super().__init__()
        if isinstance(net, torch.nn.Module):
            self.net = net
        self._fn = fn

    def forward(self, *inputs):
        return self._fn(*inputs)


def _refuse_potential(gen_sde):
    if getattr(gen_sde.score_net, "learn_potential", False):
        raise NotImplementedError(
            "export of a learned-potential score net: torch.export does not "
            "trace the gradient of the potential (ROADMAP Queue 1 item 21)")


def _export(fn, net, example, specs, polymorphic_batch):
    """``torch.export.export`` of fn on the example inputs, under
    no_grad, with a symbolic batch where asked (keyed by ``_Program``'s
    ``inputs``), without the graph's Python stack traces (debugging
    metadata that costs a third of the tracing of an unrolled solve) and
    without the example inputs in the artifact."""
    dynamic = None
    if polymorphic_batch:
        b = torch.export.Dim("b", min=MIN_BATCH)
        dynamic = {"inputs": tuple({s["batch_axis"]: b} for s in specs)}
    with torch.no_grad(), _no_stack_traces():
        exported = torch.export.export(_Program(fn, net), tuple(example),
                                       dynamic_shapes=dynamic)
    exported.example_inputs = None
    return exported


@contextlib.contextmanager
def _no_stack_traces():
    """torch.fx's stack-trace recording off, where the installed torch has
    the switch (``torch.fx.config.do_not_emit_stack_traces``; earlier
    versions have none)."""
    config = torch.fx.config
    if not hasattr(config, "do_not_emit_stack_traces"):
        yield
        return
    saved = config.do_not_emit_stack_traces
    config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        config.do_not_emit_stack_traces = saved


@contextlib.contextmanager
def _memoized_type_hints():
    """``typing.get_type_hints`` memoized while it is set: torch.export's
    deserializer calls it for every node it reads, with the same few
    classes, which took half the load of an unrolled solve."""
    orig = typing.get_type_hints
    memo = {}

    def hints(obj, *args, **kwargs):
        key = (obj, *map(id, args), *((k, id(v)) for k, v in kwargs.items()))
        if key not in memo:
            memo[key] = orig(obj, *args, **kwargs)
        return memo[key]

    typing.get_type_hints = hints
    try:
        yield
    finally:
        typing.get_type_hints = orig


def _save(exported, path, meta):
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:  # any file name, not only *.pt2
        torch.export.save(exported, f)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def export_sampler(gen_sde, path, num_samples, dim, num_steps, *,
                   method="rk4", lmbd=0.0, norm_correction=False,
                   sampler="sde", corrector_steps=0, snr=0.16,
                   dpm_grid="logsnr", polymorphic_batch=False):
    """Stage the whole sampling program (the latent transform and the
    solve, the score net baked in) with ``torch.export`` and save it to
    `path`, with the ``.json`` sidecar; returns the sidecar's dict.

    The program takes the raw draws of ``_input_specs`` and returns
    (B, dim) samples. It runs on the device of gen_sde's base SDE, traced
    on example inputs drawn from a generator seeded with 0.
    polymorphic_batch exports a symbolic batch dimension (any B ≥
    2); num_samples then only records the serving-side default. Samplers
    "sde", "ode" and "dpm" with fixed steps export; "ode" with "dopri"
    (a host read every attempt) and learned-potential score nets raise
    ``NotImplementedError``."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} (sde|ode|dpm)")
    if sampler == "ode" and method == "dopri":
        raise NotImplementedError(
            'export of sampler="ode" with method="dopri": its step control '
            "reads the host every attempt (ROADMAP Queue 1 item 20)")
    _refuse_potential(gen_sde)
    specs = _input_specs(gen_sde, num_samples, dim, num_steps,
                        sampler=sampler, method=method,
                        corrector_steps=corrector_steps)
    n_lat = sum(s["name"] not in ("noise", "corrector_noise") for s in specs)
    names = [s["name"] for s in specs[n_lat:]]

    def program(*inputs):
        x0 = gen_sde.base_sde.latent_from_draws(*inputs[:n_lat])
        kw = dict(zip(names, inputs[n_lat:]))
        return _solve_from(
            gen_sde, x0, None, num_steps, method=method, lmbd=lmbd,
            norm_correction=norm_correction, keep_all=False,
            include_t0=False, sampler=sampler,
            corrector_steps=corrector_steps, snr=snr, dpm_grid=dpm_grid, **kw)

    if sampler == "dpm":  # the host-side schedule, before tracing
        dpm_schedule(gen_sde.base_sde, num_steps, _dpm_method(method),
                     dpm_grid, torch.float32)
    device = gen_sde.base_sde.device
    example = make_draws(specs, torch.Generator(device=device).manual_seed(0))
    exported = _export(program, gen_sde.score_net, example, specs,
                       polymorphic_batch)
    meta = dict(
        kind="sampler", num_samples=num_samples, dim=dim,
        num_steps=num_steps, method=method, lmbd=lmbd,
        norm_correction=norm_correction, sampler=sampler,
        corrector_steps=corrector_steps, snr=snr, dpm_grid=dpm_grid,
        polymorphic_batch=bool(polymorphic_batch), device=device.type,
        inputs=specs)
    return _save(exported, path, meta)


def export_encoder(gen_sde, path, num_samples, dim, num_steps, *,
                   method="rk4", t0=0.0, norm_correction=False,
                   polymorphic_batch=False):
    """Stage the deterministic PF-ODE encoder (data → latent,
    ``ops/ode.encode_ode``) with ``torch.export`` and save it to `path`,
    with the ``.json`` sidecar: the deploy-side twin of
    ``export_sampler`` for inversion and editing. The program takes
    (B, dim) float32 data and returns (B, dim) latents; polymorphic_batch
    as for ``export_sampler``. Load it with ``Encoder``."""
    if method == "dopri":
        raise NotImplementedError(
            'export of the encoder with method="dopri": its step control '
            "reads the host every attempt (ROADMAP Queue 1 item 20)")
    _refuse_potential(gen_sde)

    def program(x):
        return encode_ode(gen_sde, x, num_steps, method=method, t0=t0,
                          norm_correction=norm_correction)

    device = gen_sde.base_sde.device
    spec = dict(name="x", law="data", shape=[num_samples, dim], batch_axis=0)
    example = torch.randn((num_samples, dim), device=device,
                          generator=torch.Generator(device).manual_seed(0))
    exported = _export(program, gen_sde.score_net, [example], [spec],
                       polymorphic_batch)
    meta = dict(
        kind="encoder", num_samples=num_samples, dim=dim,
        num_steps=num_steps, method=method, t0=float(t0),
        norm_correction=norm_correction,
        polymorphic_batch=bool(polymorphic_batch), device=device.type,
        inputs=[spec])
    return _save(exported, path, meta)


class _Loaded:
    """A loaded artifact and its sidecar."""

    def __init__(self, path, kind):
        meta_path = path + ".json"
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path}: the sidecar records the artifact's inputs")
        with open(meta_path) as f:
            self.meta = json.load(f)
        if self.meta.get("kind") != kind:
            raise ValueError(f"{path} holds a {self.meta.get('kind')}, not "
                             f"a {kind}")
        with open(path, "rb") as f, _memoized_type_hints():
            self.program = torch.export.load(f).module()

    def _batch(self, n):
        fixed = int(self.meta["num_samples"])
        if n is None:
            return fixed
        if not self.meta["polymorphic_batch"] and int(n) != fixed:
            raise ValueError(
                f"fixed-batch artifact exported for batch {fixed}; "
                "re-export with polymorphic_batch=True to serve other sizes")
        if int(n) < MIN_BATCH:
            raise ValueError(f"batch {n}: at least {MIN_BATCH}")
        return int(n)


class Sampler(_Loaded):
    """Serving-side handle of an exported sampling program:

        s = Sampler("model.sdeflow")
        batch = s(torch.Generator("cuda").manual_seed(0))
        # a symbolic-batch artifact takes any batch:
        batch = s(generator, num_samples=4096)

    The draws come from the generator, on its device (the artifact's)."""

    def __init__(self, path):
        super().__init__(path, "sampler")

    def draws(self, generator, num_samples=None):
        """The program's inputs drawn from `generator` (``make_draws`` of
        the sidecar's specs)."""
        return make_draws(self.meta["inputs"], generator,
                          self._batch(num_samples))

    def __call__(self, generator, num_samples=None):
        with torch.no_grad():
            return self.program(*self.draws(generator, num_samples))


class Encoder(_Loaded):
    """Serving-side handle of an exported encoder program:

        e = Encoder("model.encoder")
        z = e(x)  # x (B, dim) float32; B free for a polymorphic export
    """

    def __init__(self, path):
        super().__init__(path, "encoder")

    def __call__(self, x):
        self._batch(x.shape[0])
        with torch.no_grad():
            return self.program(x.to(torch.float32))
