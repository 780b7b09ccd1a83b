"""Run names encoding all hyperparameters into result paths.

A copy of sdeflow_tpu/experiments/naming.py:1-67 (the reference's
m_name_simu_root, MSGM_higherDim.py:409-435): the port writes its results
under the same file names, byte for byte."""

from __future__ import annotations


def run_name_root(
    sampler_name,
    sde_name,
    iterations_ref,
    num_samples_init,
    batch_size,
    num_steps_forward,
    beta_min,
    beta_max,
    beta_min_sgm,
    beta_max_sgm,
    is_msgm,
    nn_archi="MLP",
    premodule=None,
    lr=0.001,
    vtype="rademacher",
    ssm_intT=False,
    fair_comparison=False,
):
    name = (
        f"{sampler_name}/"
        f"{sde_name}_{iterations_ref}iteRefLearning_"
        f"{num_samples_init}InitSples_"
        f"{batch_size}batchSize_"
        f"{num_steps_forward}stepsForw_"
    )
    if is_msgm:
        name += f"{beta_min}beta_min{beta_max}beta_max"
    else:
        name += f"{beta_min_sgm}beta_min{beta_max_sgm}beta_max"
    if nn_archi != "MLP":
        name += f"_{nn_archi}"
    if premodule is not None:
        name += f"_{premodule}"
    if lr != 0.001:
        name += f"{lr}lr"
    if vtype != "rademacher":
        name += f"vtype={vtype}"
    if ssm_intT:
        name += "_intLoss"
    if fair_comparison:
        name += "_fairComp"
    return name


def simulation_name(
    folder, name_root, t_eps, num_steps_backward, include_t0_reverse, i_run=0,
    method="rk4",
):
    """Per-sampling-run name (reference: MSGM_higherDim.py:877-892; the
    integrator tag is new — the reference hardcodes RK4 — so rk4 names stay
    byte-identical and other methods can't overwrite rk4 results)."""
    name = (
        f"{name_root}{t_eps}t_eps{num_steps_backward}stepsBack_"
        f"{include_t0_reverse}t0infer"
    )
    if method != "rk4":
        name += f"_{method}"
    if i_run > 0:
        return f"runs/{name}_run{i_run}"
    return f"{folder}/{name}"
