#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sdeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]
                          [--only gn|driver|bf16|k7|unfused_bf16|attn_bf16|
                                  samplers|core_dit|unet_export|signal|
                                  plots]

Drives the port's paths on the grf16 MSGM arm at full width (the
VorticityUNet score net with random weights from a seed, the circulant MSGM
SDE at d=256 built from 100k SmoothedGRF samples): sampling with
norm-corrected RK4 and SSM training at batch 128, each on the U-Net's
"auto" AttentionBlock route (kernel K3) and on its "unfused" route
(GroupNorm K5, the attention core K6, two products); the unfused
AttentionBlock at a long sequence (kernel K4, and the reverse-mode pair
K7a/K7b under autograd); and denoising-score-matching training of the SGM
arm of the grf U-Net on 128×128 images at batch 128 (K5, K5b, K6, K7a,
K7b; K5b is GroupNorm's backward, run by every training path); and the
experiment driver's CLI on grf16 (both arms trained by SSM, sampled and
scored: K1, K2's solve, K3, K5, K5b); and the grf16_production preset
through the same CLI (bf16 compute in the score net: the bf16 variants of
K3, K5 and K5b; EM sampling with a Langevin corrector step: K1); and bf16
on the unfused route: the grf U-Net at 128×128 in bf16 trained by DSM and
served (the bf16 variants of K6, K4, K7a and K7b), and grf16_production
through the CLI on ``--attention-impl unfused`` (bf16 K6); and the CLI's
probability-flow ODE and DPM-Solver samplers and exact NLL on grf16 (K1,
K3 and K5 in every drift evaluation and every JVP of the likelihood); and
the DiT score nets on grf16 through the CLI (grf16_dit in fp32,
grf16_production_dit in bf16: K1 and K2's solve on the MSGM arm, the DiT
itself plain products) and the core MLP path (swissroll, gaussian,
gaussianCauchy and cauchy with a dense G: no kernel); and the U-Net's
other options with serving export (the learned potential, whose score's
reverse pass runs K5b; remat; dims 1 and 3; labels; exported programs,
whose kernels are the registered sdeflow operators); and the signal
regime on file-backed Lorenz-63 data (lorenz63_unet1d, UNet1D at d = 1000,
where K1, K2 and K2's solve take their general plans; lorenz63_dit;
lorenz63 with a dense G); and the CLI with its figures on grf16 and
lorenz63_unet1d (each MSGM arm's noising trajectory: K2's single step),
with the profiling utilities. It
holds every CUDA kernel of those paths against its plain PyTorch version:

1. prints the card's name and power limit, builds the kernels from
   sdeflow_tpu_torch/csrc with nvcc (one process per source, in parallel);
2. K1 circulant_apply against circ_math, bit for bit, at (1024, 256),
   (1000, 256), (1024, 1024) and the plans' edges (1001, 96) (warp plan,
   3 floats per lane) and (999, 1056) (general plan), the Python plan
   mirror equal to the compiled chooser at each; K1 timed at (1024, 256)
   per call, as a direct launch, its device time from a trace beside the
   smallest PyTorch kernel of the same trace (the launch floor), the bound
   and the plain version;
3. K3 fused_attention_block against attn_block_math at (1024, 64, 64) and
   (1024, 16, 128) with one head and at (1024, 64, 64) with four heads,
   all weights random and non-zero, TF32 off, rtol/atol 1e-5;
4. builds the arm (make_model, build_msgm_arm) on both routes with the same
   weights, and finds the (C, S) of every GroupNorm of one forward;
5. K5 group_norm_silu against gn_math and K5b (its backward,
   group_norm_silu_bwd) against gn_math_vjp at each of those shapes at
   B = 1024, at each of the DSM step's at B = 128, at odd sizes and at the
   launch plans' edges (slabs of 32 to 65,540 floats, S % 4 != 0, the
   stream plan), SiLU on and off: K5 rtol/atol 1e-5, K5b's dx within
   1e-5·max |dx| of the fp32 plain vjp and dγ, dβ (sums of up to 2M terms)
   within 1e-5·max of the float64 one; times both at the auto route's
   shapes beside PyTorch's GroupNorm forward (F.group_norm) and backward
   (aten.native_group_norm_backward, given the forward's statistics; K5b
   also beside the rule it replaced: autograd of the rerun gn_math);
6. K6 qkv_attention against attention_math at (1024, 64, 64) and
   (1024, 16, 128) with one head, (1024, 64, 64) with four and the DSM
   step's (128, 1024, 128) (there against attention_math in float64, since
   the fp32 plain version is itself ~1e-5 off), atol 1e-5,
   and K4 (qkv_attention above T = 1024: the tensor-core kernel
   flash_fwd.cu) at (4, 4096, 64) with one and two heads and
   (2, 2048, 128), atol 2e-5 (the online softmax sums thousands of terms in
   another order than the plain softmax); times both beside
   torch.nn.functional.scaled_dot_product_attention (K6 at the three
   one-head shapes, the DSM step's among them);
7. serves three requests of 1024 samples with 32 RK4 steps each on the
   auto route: finite (1024, 256) samples, every latent norm kept to rtol
   1e-5, and exactly 8·32 launches of K1, 44·32 of K3 and 140·32 of K5 per
   request;
8. replays the last request (same x0 and noise) ten times: plain, twice
   kernel, direct, direct, kernel, then plain. The plain runs put the
   plain versions in place of the kernel wrappers, the direct runs launch
   each kernel without its autograd.Function; max |Δ| ≤ 1e-3·max |x|
   against the request, no launch in a plain run, the exact counts in the
   others;
9. traces a 2-step request with torch.profiler: device time by kernel,
   the device's busy time and idle share;
10. the unfused route: one request on the same x0 and noise (exactly 256
   K1, 184·32 K5 and 44·32 K6 launches, no K3; within 1e-3·max |x| of the
   auto route's), replayed plain, kernel, direct, direct, kernel, plain,
   requests of the two routes in turns (auto, unfused, unfused, auto),
   and a traced 2-step request;
11. K4 on its path: one unfused AttentionBlock at (B = 4, 64×64, C = 64),
   T = 4096: the forward under no_grad, a torch.func.jvp and a gradient
   with the block's parameters requiring grad, each against the plain path
   (output and tangent 2e-5·max |plain|, gradients 1e-4·max |g|); exactly
   3 launches of K5, 1 of K4 (the no-grad forward), 2 of K7a (the jvp, the
   gradient's forward), 1 of K7b and 1 of K5b; and a trace of three no-grad
   forwards;
12. K2 circulant_rk4_step against rk4_math_fwd, bit for bit, at (128, 256),
   (1000, 256), (1024, 1024), (127, 96) and (129, 97), sb3 in [1, 2], the
   plan mirror equal to the compiled chooser, timed at (128, 256) as K1 in
   phase 2; ForwardFlow.rk4_step (kernel K2) against the generic rk4_step
   on the plain versions; K2's solve (circulant_rk4_solve_select, one
   launch for the SSM loss's forward solve) at (64, 128, 256) on grf16's
   SDE with the steps per row from grf16's t draws, all 0 and all 64: bit
   for bit against a loop of ForwardFlow.rk4_step (one K2 launch per step)
   with the masked select and against integrate_select, within 1e-6 of
   rk4_solve_select_math; its device time per case beside the bound (the z
   rows the case reads) and the launch floor; against the loop: per call,
   device time and kernels from traces, and wall time per solve with the
   draws (one randn against 64, the fills and the selects);
13. autograd through the kernels: torch.func.jvp, torch.autograd.grad and
   a double backward (create_graph: the kernel's forward, the plain
   version's differentiable backward) through each kernel's Function
   against the plain version at the paths' shapes (K1, K2 and K2's solve
   over 8 steps 1e-6; K3, K5, K6 1e-5, relative to the largest entry; K5's
   first-order gradients
   through K5b, exactly two launches), and a ResBlock's gradient through
   its JVP on cuDNN and K5 against the CPU (1e-4);
14. training on the auto route: on one batch of 128 with injected draws,
   the loss and every parameter gradient of the kernel path against the
   plain path (loss rtol 1e-4, each gradient max |Δ| ≤ 1e-3·max |g|); three
   steps of the driver's Trainer (train_msgm_arm); 20 timed bare train
   steps with exactly 1 K2 solve, no K2 step, 5 K1, 11 K3, 35 K5 and 35 K5b
   launches each (the loss reads the score as well as its JVP); then a
   train step replayed plain, kernel, kernel, plain; and the forward
   trajectory (sample_scheme_allt, the ssm_intT loss's solve) at batch 128
   with exactly 64 K2 step launches, its last state with injected normals
   equal to K2's solve taking every step;
15. traces one train step with torch.profiler, on the kernel path and on
   the plain path;
16. training on the unfused route: the same agreement check, 10 timed bare
   train steps with exactly 1 K2 solve, 5 K1, 46 K5, 46 K5b and 11 K6
   launches each,
   5 steps of each route in turns (auto, unfused, unfused, auto), and one
   traced step;
17. K7a (flash forward with lse) and K7b (flash backward) against their
   plain versions, TF32 off, at (4, 4096, 64) with one and two heads,
   (2, 2048, 128) and the ragged (2, 1000, 64): the output within
   2e-5·max |plain|, lse within 1.5e-5 of the plain version run in
   float64 and within 1e-5 of the fp32 plain version, dqkv within
   1e-4·max |plain|; K7a's lse on 20 more draws at (2, 2048, 128) held
   to both the same way, with the fp32 plain version's own distance from
   float64; their
   times at (4, 4096, 64) per call through FlashAttention (its forward; its
   backward alone) and as a direct launch, beside the plain versions, the
   bound and scaled_dot_product_attention's forward and backward; and the
   direct launches and SDPA's forward and backward at the DSM path's own
   shape (128, 4096, 64), a few calls each;
18. DSM training of the SGM arm of _grf(128) (build_sgm_arm, random
   weights, SmoothedGRF(128, ell 2), lr 1e-4, bare Adam; every AttentionBlock
   on the unfused route: 5 at T = 4096, 6 at T = 1024): K5 and K5b timed
   at the step's GroupNorm shapes at batch 128 beside
   PyTorch's GroupNorm forward and backward, K5b's old rule
   and the bounds; on one batch of 8 with
   injected t and ε, the loss and every parameter gradient against the plain
   path (rtol 1e-4, 1e-3·max |g|) with both paths' peak memory; two
   Trainer(loss="dsm") steps with their ELBO prints; 5 timed bare steps at
   batch 128 with exactly 46 K5, 46 K5b, 6 K6, 5 K7a and 5 K7b launches
   each (no K1-K4); one step of the plain and the kernel path in turns
   (plain, kernel, kernel, plain) at batch 8;
19. traces one DSM step at batch 128 with torch.profiler, with the device
   time under GroupNormSiLUBackward;
20. the experiment driver: first, on one batch of 128 with injected t, ε
   and probe, the SGM arm's SSM loss and every parameter gradient on the
   kernel path against the plain path (loss rtol 1e-4, each gradient
   1e-3·max |g|; exactly 11 K3, 35 K5 and 35 K5b launches, no K1, no K2),
   and one traced SGM SSM step at batch 128 (torch.profiler); then
   ``sdeflow_tpu_torch.run.main`` with ``--preset grf16 --iterations
   8 --num-samples 1024 --steps-backward 32 --eval-mmd --no-plots`` in a
   temporary cwd and results directory, every kernel count set to 0 just
   before and read just after (K1, K2's solve, K3, K5 and K5b must
   launch). Both arms train 8 steps at batch 128 with finite losses and
   moving parameters, each bare step (the ELBO prints aside) with exactly
   the launches of phase 14 (MSGM) or the SGM step above, timed with its
   peak memory; each arm's generation run gives a finite (33, 1024, 256)
   trajectory with exactly 256 K1 (MSGM; 0 for SGM), 1,408 K3 and 4,480 K5
   launches, MSGM keeping every latent norm to rtol 1e-5 and SGM not, and
   the SGM run replayed on the plain path from the same generator state
   agrees at each state within 1e-3 of the plain state's rms, on the rows
   that filter_blowups keeps; the six result arrays are finite, the
   train-to-test MMD and SWD are equal between the arms, each arm's MMD²
   on the card agrees with a float64 CPU recomputation within rtol 1e-3,
   one MMD and one SWD at (1023, 256) are timed, the metric arrays, the
   per-run samples and trajectories and the final checkpoints exist under
   the JAX package's names, and ``--just-load-mmd`` reloads the arrays
   equal;
21. the bf16 variants against their plain twins (gn_math and gn_math_vjp,
   attn_block_math in bf16): K5 and K5b at every (C, S) of a grf16
   forward's GroupNorm mix at B = 1024 and B = 128, SiLU on and off, and
   at every (C, S, SiLU) of the bf16 DSM step's mix at B = 128, whose
   plans (K5 bf16: clusters of 1, 2 and 4 blocks; K5b bf16: 1, 2, 4 and 8)
   are asserted (K5 within 1.6e-2·max |plain|, two bf16 ulps, and no
   farther from the fp32 plain than 1.5× the twin plus 1e-3·max; K5b's dx
   within 2e-2·max |dx| of the vjp of the bf16 forward evaluated in fp32,
   dγ and dβ within 1e-3·max of float64; both equal bit for bit on a
   second run); K3 with random non-zero weights at
   (64, 64) and (16, 128) at B = 1024 and B = 128, (16, 64, 64) with four
   heads and (4, 256, 32) and (4, 256, 64) with eight heads and 32 groups,
   by phase 23's two gates (within 2e-2·max |plain bf16|; no farther from
   the fp32 plain than 1.5× the twin plus 1e-3·max), equal bit for bit on
   a second run, one device kernel per direct call (a trace); their
   times at grf16's GroupNorm mixes (B = 1024, B = 128) and K3's two
   shapes at both batches beside the plain versions, PyTorch's GroupNorm
   forward and backward in bf16 and the bounds (bf16 products at 989
   TFLOP/s, bytes with K3's weights read in fp32);
22. the production preset: the SGM arm's bf16 SSM loss and every
   gradient, kernel path against plain on one batch of 128 (rtol 1e-2,
   3e-2·max |g|, exact launches), a traced bf16 SSM step and a traced
   2-step request (EM plus one corrector step); then
   ``sdeflow_tpu_torch.run.main`` with ``--preset grf16_production
   --iterations 8 --num-samples 1024 --eval-mmd --no-plots`` (batch 128,
   EM-32 plus one Langevin corrector step; cuDNN's deterministic
   algorithms, so that the replay below compares the same trajectories
   on every run), every kernel count set to 0
   just before and read just after: each arm's 8 bf16 steps with phase
   20's launches, finite losses, moving parameters, and parameters, Adam
   moments and EMA in fp32; each arm's request a finite (33, 1024, 256)
   trajectory with exactly 22·32 K3 and 70·32 K5 launches (K1 counted),
   MSGM's norms kept to rtol 1e-5, the corrector's step size ε > 0 on at
   least one step of each arm (counted); the MSGM request replayed on the
   plain path within 2e-2 of each state's rms on the rows filter_blowups
   keeps, or, against the same request computed in fp32, the kernel run
   no farther than 1.5× the plain bf16 run in rms |Δ| and in max |Δ|
   (plus 2e-2), relative to each state's rms (bf16's own noise on the
   same draws), and within 2e-3 of the rms after the first
   predictor-corrector step (readings there: 3e-4 to 4e-4); finite
   metrics, √MMD and SWD printed for both arms;
23. the bf16 entries of K6, K4, K7a and K7b against their plain twins,
   TF32 off: K6 at (1024, 64, 64) with one and four heads, (1024, 16, 128)
   and (128, 1024, 128); K4 and K7a at (4, 4096, 64) with one and two
   heads and (2, 2048, 128); K7a and K7b also at the ragged (2, 1000, 64).
   Two gates, both held: within 2e-2·max |plain bf16| of the plain bf16
   twin, and no farther from the fp32 plain version on the widened bf16
   inputs than 1.5× the plain bf16 twin's own distance plus 1e-3·max;
   K7a's lse within 1e-5 of the fp32 plain's, K7b's dqkv within 1e-2·max
   of attention_flash_bwd_math in bf16 (fp32 math rounded once) and equal
   bit for bit on a second run (one writer per element); on each K4 shape
   K4's out equal to K7a's bit for bit (one wgmma body under two symbols)
   and K7a's out and lse equal bit for bit on a second run; their
   times per call through the Function and as direct launches at
   (4, 4096, 64), (128, 4096, 64) (K4, K7a, K7b) and (128, 1024, 128) and
   grf16's two shapes (K6), beside the plain twins, SDPA in bf16 (its
   backward for K7b) and the bounds (bf16 products at 989 TFLOP/s); and
   the "auto" AttentionBlock (4, 64, 16, 16) with 8 heads in bf16 (T =
   256, which bf16 K3 took only unfused before it read its weights in the
   kernel): one K3 bf16 launch, no K5 and no K6, held by the same two
   gates against the plain path;
24. the grf U-Net at 128×128 in bf16 (phase 18's cell with compute dtype
   bfloat16 and eps): on one batch of 8 with injected t and ε the DSM loss
   and every gradient, kernel path against plain (loss rtol 1e-2, 3e-2 of
   the loss's largest gradient entry, both paths measured against fp32);
   two Trainer(loss="dsm") steps; 5 timed bare steps at batch 128 with
   exactly 46 K5, 46 K5b, 6 K6, 5 K7a and 5 K7b launches, bf16 entries
   only, and peak memory beside phase 18's fp32; one traced step; a no-grad
   request at batch 16 (4 EM steps and one corrector step each) with
   exactly 368 K5, 40 K4 and 48 K6 launches, finite, traced, replayed on
   the plain path and held as phase 22 holds its replay;
25. ``sdeflow_tpu_torch.run.main`` on grf16_production with
   ``--attention-impl unfused`` (phase 22's run and checks without the
   replay): per bf16 SSM step 46 K5, 46 K5b and 11 K6 (MSGM: 5 K1, one K2
   solve), per request 92·32 K5 and 22·32 K6, no K3 and no float32 entry of
   an attention kernel; finite losses and metrics, √MMD and SWD printed;
26. the samplers and the likelihood through the CLI (phase 20's reduction,
   fp32, the auto route), every kernel count set to 0 just before each run
   and read just after: ``--sampler ode --eval-mmd --eval-nll`` (RK4-32,
   MSGM norm-corrected): each arm's ODE request a finite (33, 1024, 256)
   trajectory with exactly 4·32 K1 (MSGM; 0 SGM), 44·32 K3 and 140·32 K5
   launches, MSGM's norms kept to rtol 1e-5, replayed on the plain path
   from the same latents within 1e-3·max |x|; each arm's NLL (nll_summary:
   512 test points, 64 RK4 steps, one Hutchinson probe) finite on every
   point with exactly 11, 35 and (MSGM) 1 launches of K3, K5 and K1 a
   stage, the same 512 points with the driver's own probes over 8 RK4
   steps on the kernel and the plain path within 1e-3 of the largest
   bits/dim; the MSGM arm's SDE request on the same trained arm timed
   beside its ODE request; ``--sampler dpm --backward-method dpm2m --steps-backward 16``:
   SGM's request with exactly 11·16 K3 and 35·16 K5 launches and no K1,
   MSGM's logged fallback to the SDE with RK4; then a dopri solve
   (rtol = atol = 1e-5) of 256 samples on each trained arm of the ODE run,
   finite (MSGM's norms kept), its NFE, steps and time, with exactly
   11·NFE K3 and 35·NFE K5 launches (and NFE K1 on MSGM);
27. the DiT score nets and the core MLP path (``--only core_dit``), every
   kernel count set to 0 just before each CLI run and read just after:
   ``run.main`` on grf16_dit (phase 20's reduction, fp32, RK4-32) and on
   grf16_production_dit (phase 22's, bf16, EMA, eps on SGM, EM-32 plus one
   corrector step): the runs launch K1 and K2's solve and nothing else;
   each arm's 8 bare SSM steps timed with their peak memory, exactly 5 K1
   and 1 K2 solve (MSGM) or none (SGM) each, finite losses, moving
   parameters (bf16: the DiT computing in bf16, parameters, Adam moments
   and EMA fp32); each arm's request a finite (33, 1024, 256) trajectory
   timed (ms, samples/s, peak), exactly 8·32 K1 (RK4) or 4·32 (PC) on
   MSGM and none on SGM, MSGM's norms kept to rtol 1e-5, the corrector's
   step size ε > 0 on a step of each arm; the MSGM request replayed on
   the plain path from the same generator state (fp32 within 1e-3·max
   |x|; bf16 by phase 22's gates, with the same request in fp32); finite
   metrics; a traced MSGM SSM step at batch 128 and a traced 2-step
   request per preset. Then the core path: swissroll SGM by the Trainer
   at the JAX package's end-to-end budget (MLP, 3,000 steps at batch 256,
   EM-100 on 4,000 samples, √MMD < 0.15 beside the floor), its MSGM
   GaussianCauchy run with a dense G (300 steps at batch 64, RK4-32
   norm-corrected, norms to rtol 1e-4), and the CLI on swissroll,
   gaussian (d = 2 … 32, a dense G of 32³) and cauchy at 300 iterations
   with --eval-mmd, each launching no kernel;
28. the rest of the U-Net and serving export (``--only unet_export``),
   every kernel count set to 0 just before each run and read just after:
   grf16's VorticityUNet with learn_potential (random weights, a gentler
   potential head): its score on 1,024 points against the plain path
   within 1e-4 of the largest; the RK4-32 norm-corrected request of 1,024
   samples with exactly 8·32 K1 and, per score evaluation (4·32), one K3
   per AttentionBlock and two K5 and two K5b per ResBlock of the potential
   (its reverse pass with grad mode off), norms to rtol 1e-5, replayed on
   the plain path within 1e-3·max |x|, timed; 8 SSM steps at batch 128
   (exactly 5 K1, 1 K2 solve and the potential's K3, K5, K5b a step,
   finite losses, moving parameters, ms, peak memory); one DSM step of the
   grf U-Net at 128×128 (batch 128) in fp32 and in bf16 with and without
   use_checkpoint on the same draws, with cuDNN's deterministic
   algorithms, in turns (plain, remat, remat, plain): the loss equal, the
   gradients within 1e-4 (fp32: K7b's atomic sums) or 1e-3 (bf16) of the
   largest, peak memory, ms and launches both ways (remat reruns each
   block's K5, K6 and K7a); a dims=3 and a dims=1 U-Net and a
   class-conditional grf16 U-Net against the plain path within 1e-4 of
   the largest output; then three exports, made by a worker process
   started after phase 6 so that its tracing overlaps the other phases
   (the arms built from a seed of their own, here and there alike, held
   by a digest of their weights, latent tables and data):
   grf16_production's PC request (bf16, EM-32 plus one corrector step)
   with a symbolic batch, served at 1,024 and 256, the fp32 MSGM request
   (RK4-16, norm-corrected) and the PF-ODE encoder (RK4-4,
   norm-corrected), each with its export seconds and artifact bytes,
   loaded by a fresh process that imports no sdeflow_tpu_torch.models or
   .sde module (its load seconds) and served there against the eager
   program on the same draws: max |Δ| within 1e-6 of the largest value
   (expected 0), equal launches, ms both ways;
29. the signal regime (``--only signal``): a Lorenz-63 fixture of 1,536
   windows of 1,000 steps written under a temporary root by
   tools/l63_fixture.py, then, every kernel count set to 0 just before each
   CLI run and read just after, ``run.main`` with ``--data-root`` on
   lorenz63_unet1d at phase 20's reduction (UNet1D base 32, mults (1, 2,
   4), emb 128 at d = 1000, the circulant MSGM SDE, batch 256): each arm's
   8 bare SSM steps timed with their peak memory, exactly 5 K1 and 1 K2
   solve (MSGM) or none (SGM) each, finite losses, moving parameters; each
   arm's RK4-32 request of 1,024 samples timed, exactly 8·32 K1 on MSGM
   and none on SGM, MSGM's norms kept to rtol 1e-5, the MSGM request
   replayed on the plain path within 1e-3·max |x|; finite metrics. Then
   K1 and K2 at (256, 1000) and (1024, 1000) and K2's 16-step solve at
   (16, 256, 1000) (the arm's t draws, all 0, all 16), each on its general
   plan, bit for bit against its plain version (the solve also against a
   loop of K2 steps), timed beside its bound; a traced MSGM SSM step and
   2-step request; lorenz63_dit (DiT1D, d = 1000 padded to 1,008) through
   the CLI with the same checks, and lorenz63 (d = 16, dense G, MLP),
   which launches no kernel;
30. the plots and the profiling utilities (``--only plots``): whether
   matplotlib is importable on the card, and its version;
   ``device_seconds`` of K1 at (1024, 256) within a factor of 2 of its
   CUDA-event time per call (phase 2's), ``memory_report``'s card figures
   equal to ``torch.cuda.memory_stats``, ``peak_flops`` the table's entry
   for the card's name, ``trace`` writing a Chrome trace that holds every
   K1 kernel the profiler saw (three windows of 200 calls: at once, after
   a 20 ms lead, each synchronized); where the card has no matplotlib,
   both CLI runs' ImportError (naming --no-plots) before anything is
   built; then, every kernel count set to 0 just before each CLI run and
   read just after, ``run.main`` with its figures on (phase 20's flags
   without --no-plots, and --print-ram) on grf16 and (phase 29's) on
   lorenz63_unet1d on a fixture: each MSGM arm's noising trajectory of
   the test set exactly 64 (grf16, (1024, 256), K2's warp plan) or 16
   (lorenz63_unet1d, (1024, 1000), its general plan) K2 single steps, the
   SGM arm's none, each bit for bit with its replay on the plain path
   from the same draws, MSGM's norms kept; the rest of each run's
   launches those of phase 20's and phase 29's runs; every file the JAX
   driver writes for the preset present and non-empty, and no other
   (without matplotlib: the driver's plotting calls swapped for their
   figures' numbers through the port's functions on the card's tensors,
   ``figure_numbers``, each finite, no PNG, and the files besides the
   figures); each ``RAM:`` line's card figures equal to
   ``torch.cuda.memory_stats`` at that moment; the seconds inside the
   plotting calls against the run's.

Ends with the kernel table as one JSON line (K1, K2, K2's solve, K3, K5,
K5b, K6, K4, K7a, K7b, the bf16 variants of K3, K5, K5b with their
launches in the production run and those of K6, K4, K7a, K7b with their
launches in phases 24 and 25, each with its launches in the driver's
run, in phase 26's two runs, in phase 27's two DiT runs, in phase
28's runs (by entry point, fp32 and bf16 apart), in phase 29's runs and
in phase 30's,
with K1's, K2's and the solve's d = 1000 times: per
call through the autograd.Function and as a
direct launch, device time, bound, plain version, the launch floor for
K1, K2 and the solve, and the library call where one computes the same
function; the
bound is the largest of the bytes over 3.35 TB/s, the matrix-product flops
three times over 494.7 TFLOP/s dense TF32, and the other flops over
67 TFLOP/s fp32), then
{"ok": true, "device": {...}} as the last line. Exits non-zero without a
CUDA device, outside the repository, or when any check fails. With
--record, also writes the full record (every measurement, the profiles'
top kernels) as JSON to PATH. With --only, builds the kernels and runs one
part: gn times K5 and K5b at both GroupNorm mixes, and K5 bf16 at its
three mixes with its device time and each mix's means beside the bound
and F.group_norm, with one traced DSM step; driver runs phase 20; bf16 phases 21 and 22; unfused_bf16 phases
23, 24 and 25; k7 times K7a and K7b
at (128, 4096, 64), K7a's lse sweep (recorded, not held) and five bare DSM
steps at batch 128 (copied beside another tree of the package, it times
that tree: ``k7_timing``); attn_bf16 the same for the bf16 kernels K6 at
(128, 1024, 128), K4 at (4, 4096, 64) and (16, 4096, 64), K7a and K7b at
(128, 4096, 64) beside SDPA, the bf16 DSM step with its trace and phase
24's batch-16 request with its trace (``attn_bf16_timing``); samplers
phase 26; core_dit phase 27; unet_export phase 28; signal phase 29;
plots phase 30.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

N_SAMPLES, DIM, STEPS, REQUESTS = 1024, 256, 32, 3
PROFILED_STEPS = 2
FORWARDS_PER_STEP = 4  # RK4
K1_PER_STEP = 8
GROUP_NORMS, ATTN_BLOCKS = 35, 11  # per grf16 U-Net forward
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # fp32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12  # dense TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12    # dense bf16 on the tensor cores
TF32_PASSES = 3  # 3xTF32: fp32 accuracy from three TF32 products
# K1 and K2: the paths' shapes, a warp-plan edge (d = 96: 3 floats per
# lane, no float4), the general plans (d = 1,056 past 1,024; d = 97) and
# B not a multiple of the rows per block
K1_SHAPES = [(1024, 256), (1000, 256), (1024, 1024), (1001, 96),
             (999, 1056)]
K2_SHAPES = [(128, 256), (1000, 256), (1024, 1024), (127, 96), (129, 97)]
TRAIN_BATCH, TRAIN_STEPS = 128, 64  # grf16: batch 128, 64 forward steps
WARM_STEPS, TIMED_STEPS, REPLAY_STEPS = 3, 20, 5
TIMED_STEPS_UNFUSED = 10
# launches per bare train step: K2's solve once (the whole 64-step forward
# solve), K2's step never; K1 four times in the one-step fallback and once
# in the loss field; the U-Net's kernels once per call of the one U-Net
# forward under the JVP (the jvp and backward rules run the plain versions)
K1_PER_TRAIN, K2_PER_TRAIN, K2_SOLVE_PER_TRAIN = 5, 0, 1
K3_SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (1024, 64, 64, 4)]
BLOCK_MIX = {(64, 64): 5, (16, 128): 6}  # AttentionBlocks per forward
# (B, C, S, groups): slabs of 15, 15 and 8,192 floats (a cluster of two)
K5_ODD = [(3, 5, 7, 5), (2, 10, 3, 2), (2, 64, 4096, 32)]
# the launch plans' edges (groupnorm.launch_plan): slabs of n = S floats
# just below and above each threshold of the lanes per slab (32, 64), the
# vectors per lane (128, 1,024), the cluster size (8,192, 16,384) and the
# stream plan (65,536, beyond a cluster's registers); S % 4 != 0 (1,023,
# 1,025 and 33,333 floats, the last streamed); a cluster block ending inside
# a channel (C/G = 2, S = 4,100); 8-lane slabs past the last whole block
K5_EDGES = [(3, 32, s, 32) for s in (32, 36, 64, 68, 128, 132, 1024, 1028,
                                     8192, 8196, 16384, 16388, 65536, 65540,
                                     1023, 1025, 33333)] + [
    (2, 64, 4100, 32), (3, 10, 16, 5)]
K6_SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (1024, 64, 64, 4),
             (128, 1024, 128, 1)]
K6_DSM = (1024, 128)  # (T, C) of K6 on the DSM step: its 32x32 level
K4_SHAPES = [(4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1)]
LONG_BLOCK = (4, 64, 64, 64)  # (B, C, H, W): T = 4096
# K7a/K7b: the T = 4096 blocks' shape, two heads, a head width of 128 and a
# ragged T for the kernels' edge masking
K7_SHAPES = [(4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1),
             (2, 1000, 64, 1)]
# K7a's lse against the plain version in float64 (1.5e-5: at C = 128,
# |lse| ~ 14, the fp32 plain version itself lies up to 5.42e-6 from it) and
# against the fp32 plain version (1e-5, PR 5's limit; the two-accumulator
# score chain missed it on some draws until K7a took its scores through a
# fresh accumulator per k-step)
K7_LSE_TOL, K7_LSE_FP32_TOL = 1.5e-5, 1e-5
# the lse sweep: draws at the C = 128 shape, from a generator of their own
K7_LSE_SHAPE, K7_LSE_DRAWS, K7_LSE_SEED = (2, 2048, 128, 1), 20, 123
# the SGM DSM slice: the grf U-Net on 128×128 SmoothedGRF images at grf's
# batch; AttentionBlocks per forward at (C, H·W): 5 at T = 4096, 6 at 1024
SGM_NPIXEL, SGM_BATCH, SGM_AGREE_BATCH, SGM_TIMED_STEPS = 128, 128, 8, 5
SGM_BLOCKS = {(64, 4096): 5, (128, 1024): 6}
# (C, S, silu) -> GroupNorm32 calls per forward of that U-Net (32 groups)
SGM_GN_MIX = {(32, 4096, True): 1, (32, 16384, True): 8, (64, 1024, True): 1,
              (64, 4096, False): 5, (64, 4096, True): 6,
              (64, 16384, True): 2, (96, 4096, True): 1,
              (96, 16384, True): 1, (128, 1024, False): 6,
              (128, 1024, True): 10, (128, 4096, True): 1,
              (192, 1024, True): 1, (192, 4096, True): 1,
              (256, 1024, True): 2}
SGM_WANT = {"group_norm_silu": 46, "group_norm_silu_bwd": 46,
            "qkv_attention": 6,
            "qkv_attention_stats": 5, "qkv_attention_bwd": 5}
# kernel symbols in traces (every plan of a kernel); K2's step and its
# solve launch the same kernels (rk4_warp_kernel, rk4_block_kernel); K5b's
# entry launches gn_silu_bwd_kernel_* and then gn_silu_bwd_params (its dγ,
# dβ sums over the batch)
SYMBOL = {"circulant_apply": "circulant_apply", "circulant_rk4_step": "rk4_",
          "circulant_rk4_solve": "rk4_",
          "fused_attention_block": "attn_block_kernel",
          "group_norm_silu": "gn_silu_kernel",
          "group_norm_silu_bwd": "gn_silu_bwd_kernel",
          "qkv_attention": "qkv_attention_kernel",
          "qkv_attention_flash": "flash_fwd_kernel",
          "qkv_attention_stats": "flash_fwd_stats_kernel",
          "qkv_attention_bwd": "flash_bwd_kernel"}
# the bf16 variants' symbols: K3's kernel has its own name; K5's and K5b's
# carry __nv_bfloat16 among their template arguments (a trace of a bf16
# path holds no fp32 GroupNorm kernel)
SYMBOL_BF16 = {"fused_attention_block": "attn_block_bf16_kernel",
               "group_norm_silu": "gn_silu_kernel",
               "group_norm_silu_bwd": "gn_silu_bwd_kernel",
               "qkv_attention": "qkv_attention_bf16_kernel",
               "qkv_attention_flash": "flash_fwd_bf16_kernel",
               "qkv_attention_stats": "flash_fwd_stats_bf16_kernel",
               "qkv_attention_bwd": "flash_bwd_dkdv_bf16_kernel"}
# K7b's bf16 entry launches its dK/dV kernel and then its dQ kernel
K7B_BF16_DQ = "flash_bwd_dq_bf16_kernel"
KERNEL_SYMBOLS = (*dict.fromkeys(SYMBOL.values()), "gn_silu_bwd_params",
                  *(v for k, v in SYMBOL_BF16.items()
                    if k == "fused_attention_block" or "qkv" in k),
                  K7B_BF16_DQ)


def log(*a):
    print(*a, flush=True)


def per_forward(route):
    """Kernel launches of one U-Net forward on an AttentionBlock route."""
    fused = route == "auto"
    return {"fused_attention_block": ATTN_BLOCKS if fused else 0,
            "group_norm_silu": GROUP_NORMS + (0 if fused else ATTN_BLOCKS),
            "qkv_attention": 0 if fused else ATTN_BLOCKS,
            "qkv_attention_flash": 0, "qkv_attention_stats": 0,
            "qkv_attention_bwd": 0, "group_norm_silu_bwd": 0}


def serve_want(route):
    forwards = FORWARDS_PER_STEP * STEPS
    return {"circulant_apply": K1_PER_STEP * STEPS, "circulant_rk4_step": 0,
            "circulant_rk4_solve": 0,
            **{k: n * forwards for k, n in per_forward(route).items()}}


def train_want(route):
    # the SSM loss reads the score (the primal) as well as its JVP, so the
    # step's backward runs each GroupNormSiLU's reverse pass once: K5b
    fwd = per_forward(route)
    return {"circulant_apply": K1_PER_TRAIN,
            "circulant_rk4_step": K2_PER_TRAIN,
            "circulant_rk4_solve": K2_SOLVE_PER_TRAIN, **fwd,
            "group_norm_silu_bwd": fwd["group_norm_silu"]}


def cuda_ms(fn, iters=50, warmup=5):
    """Mean milliseconds per call of fn(), from CUDA events around
    `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, product_flops, other_flops):
    """The least time the card could take: the largest of the bytes over
    the memory rate, the matrix-product flops over dense TF32 three times
    over (3xTF32 is how the tensor cores reach fp32 accuracy) and the other
    flops over the fp32 rate outside the tensor cores."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(
                 TF32_PASSES * product_flops / TF32_FLOPS_PER_S,
                 other_flops / FP32_FLOPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


# each cost: (bytes moved, matrix-product flops, other flops)
def k1_cost(b, d):
    # reads sqrt_beta, y, w once and writes out; 6 flops per element
    return 4 * (b + 3 * b * d), 0, 6 * b * d


def k2_cost(b, d):
    # reads sb3, x, w once and writes out; per element 4 stencil stages of
    # 6 flops, 5 for the stage states, 5 for the sum and 2 to combine
    return 4 * (3 * b + 3 * b * d), 0, 36 * b * d


def solve_cost(sel, d, n):
    # what these select counts need: x0 read and kept written once, the z
    # rows of the steps each row takes (sum of sel), the √β table and sel;
    # per element of those steps K2's 36 flops and 1 for the √δ scale
    steps = int(sel.sum().item())
    b = sel.numel()
    return 4 * (steps * d + 2 * b * d + 3 * n) + 8 * b, 0, 37 * steps * d


def k3_cost(b, t, c, heads):
    # products: qkv (2·T·C·3C), q·kᵀ and p·v (4·T²·C), proj (2·T·C²);
    # the GroupNorm, biases, residual (8 per element) and softmax (~5 per
    # score) on the CUDA cores
    nbytes = 4 * (2 * b * t * c + 4 * c * c + 6 * c)
    products = 2 * t * c * 3 * c + 4 * t * t * c + 2 * t * c * c
    return nbytes, b * products, b * (8 * t * c + 5 * heads * t * t)


def k5_cost(b, c, s, silu, size=4):
    # reads x, gamma, beta once and writes out (x and out of `size` bytes
    # an element, gamma and beta fp32); per element 1 flop for the mean, 3
    # for the variance, 4 for the affine, 4 more for the SiLU
    return (2 * size * b * c * s + 8 * c, 0,
            (8 + 4 * silu) * b * c * s)


def k5b_cost(b, c, s, silu, size=4):
    # reads x, dy, gamma, beta once, writes dx, dgamma, dbeta; per element
    # 4 flops for the statistics, 4 for x̂ and h, 4 for the sums of g and
    # g·x̂, 6 for d, its sums and dx, 8 more for the SiLU's derivative
    return (3 * size * b * c * s + 16 * c, 0,
            (18 + 8 * silu) * b * c * s)


def k3_bf16_cost(b, t, c, heads):
    # K3's work in bf16: x read and out written in bf16, the two weight
    # matrices (4 C² floats) and the four vectors read in fp32, as the
    # kernel takes them
    _, products, other = k3_cost(b, t, c, heads)
    return 2 * 2 * b * t * c + 4 * (4 * c * c + 6 * c), products, other


def bound_bf16_ms(nbytes, product_flops, other_flops):
    """bound_ms for a bf16 kernel: its products on the bf16 tensor cores
    (one pass), the rest in fp32 on the CUDA cores."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(product_flops / BF16_FLOPS_PER_S,
                               other_flops / FP32_FLOPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def k6_cost(b, t, c, heads):
    # reads qkv (3C) and writes out (C) per row; 2·T·C each for q·kᵀ and
    # p·v per row; 2 to scale q and k, ~5 per score for the softmax
    return (16 * b * t * c, b * 4 * t * t * c,
            b * (5 * heads * t * t + 2 * t * c))


def k7a_cost(b, t, c, heads):
    # K6's work, and lse written: 4 bytes per head and row
    nbytes, products, other = k6_cost(b, t, c, heads)
    return nbytes + 4 * b * heads * t, products, other


def k7b_cost(b, t, c, heads):
    # reads qkv (3C), dO (C), lse and Δ, writes dqkv (3C) per row;
    # 2·T·ch per score for each of q·kᵀ, dO·vᵀ, pᵀ·dO, dSᵀ·q and dS·k
    # (10·T²·ch per head), ~4 per score for p and dS
    return (4 * b * t * (7 * c + 2 * heads), b * 10 * t * t * c,
            b * 4 * heads * t * t)


def randomize_(module, generator):
    """Random non-zero values for every parameter, in place: weights
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            z = torch.randn(p.shape, generator=generator, device=p.device)
            if p.ndim >= 2:
                # DenseParams keep (in, out); Linear and Conv2d lead with out
                fan_in = p.shape[0] if name.endswith(".kernel") else p[0].numel()
                p.copy_(z / fan_in**0.5)
            elif name.endswith("scale"):
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)


def trace(fn, ops=("GroupNormSiLUBackward",)):
    """Run fn() once (warm) and once under torch.profiler: device time by
    kernel name, the device's busy time (union of kernel intervals), idle
    share of the traced wall time, the device time of PyTorch's own
    elementwise and reduction kernels, and that of the kernels launched
    under each CPU op named in `ops` (outermost spans only)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, without the spans of user annotations (the optimizer
    # step's "Optimizer.step#Adam.step" is recorded on the device's track)
    kernels = [e for e in p.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, calls + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    per_launch, total = {}, {}
    for short in KERNEL_SYMBOLS:
        hits = [(ms, n) for name, (ms, n) in by_name.items() if short in name]
        if hits:
            total[short] = sum(h[0] for h in hits)
            per_launch[short] = total[short] / sum(h[1] for h in hits)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]

    def outermost(e, op):
        parent = e.cpu_parent
        while parent is not None:
            if op in parent.name:
                return False
            parent = parent.cpu_parent
        return op in e.name

    aten_ms = sum(ms for name, (ms, _) in by_name.items()
                  if "at::native::" in name)
    op_ms = {op: sum(e.device_time_total for e in p.events()
                     if e.device_type == DeviceType.CPU and outermost(e, op))
             / 1e3 for op in ops}
    return {
        "wall_ms": wall_ms, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / 1e3 / wall_ms,
        "kernel_ms_total": sum(ms for ms, _ in by_name.values()),
        "kernel_launches": len(kernels),
        "per_launch_ms": per_launch, "ms_by_symbol": total,
        "op_device_ms": op_ms,
        "aten_native_ms": aten_ms,
        "top": [{"name": n, "ms": ms, "calls": c} for n, (ms, c) in top],
    }


def log_trace(what, prof):
    log(f"profiled {what}: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}), "
        f"{prof['kernel_launches']} kernels")
    for op, ms in prof["op_device_ms"].items():
        log(f"  {ms:9.3f} ms  device time under {op}")
    log(f"  {prof['aten_native_ms']:9.3f} ms  in PyTorch's own elementwise "
        "and reduction kernels (at::native)")
    for row in prof["top"]:
        log(f"  {row['ms']:9.3f} ms  {row['calls']:5d}x  {row['name'][:90]}")


def kernel_times(fn, reps, tiny=None):
    """Device times (ms) by kernel name over `reps` calls of fn() under
    torch.profiler, each call followed by tiny() if given; one window for
    all calls (a window of a few short kernels can come back empty)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
            if tiny is not None:
                tiny()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(list)
    for e in p.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name].append(e.device_time_total / 1e3)
    return by_name


def device_times(fn, symbol, reps=50):
    """Device time per launch of the kernels whose name holds `symbol`
    over `reps` calls of fn(), each call followed by one tiny PyTorch
    kernel (an add to one float): the smallest PyTorch kernel's mean device
    time in that trace is the card's launch floor for one tiny launch.
    Returns (ms per launch, floor ms, launches per call)."""
    one = torch.zeros(1, device="cuda")
    for _ in range(3):  # the profiler has returned a window without events
        by_name = kernel_times(fn, reps, lambda: one.add_(1.0))
        mine = [t for name, ts in by_name.items() if symbol in name
                for t in ts]
        floors = [sum(ts) / len(ts) for name, ts in by_name.items()
                  if "at::native::" in name]
        if mine and floors:
            return sum(mine) / len(mine), min(floors), len(mine) / reps
    raise AssertionError(f"no {symbol} kernel or no PyTorch kernel in three "
                         f"traces (kernels: {sorted(by_name)[:8]})")


def kernels_per_call(fn, reps=20, tries=5):
    """Device kernels per call of fn() by name, from a trace of `reps`
    calls each followed by a one-element add (its kernel not counted). A
    trace counts only where it holds all `reps` adds and a whole number of
    each other kernel per call: the profiler has dropped most events of a
    window of short kernels."""
    one = torch.zeros(1, device="cuda")
    tick = lambda: one.add_(1.0)  # noqa: E731
    for _ in range(tries):
        marks = set(kernel_times(tick, reps))
        by_name = kernel_times(fn, reps, tick)
        if (len(marks) == 1 and len(by_name.get(min(marks), ())) == reps
                and all(len(v) % reps == 0 for v in by_name.values())):
            return {n: len(v) / reps for n, v in by_name.items()
                    if n not in marks}
    raise AssertionError(f"no trace of {reps} calls held every event in "
                         f"{tries} tries")


def device_per_call(fn, reps):
    """Device time (ms) and kernels per call of fn(), from one trace of
    `reps` calls."""
    by_name = kernel_times(fn, reps)
    return (sum(map(sum, by_name.values())) / reps,
            sum(map(len, by_name.values())) / reps)


@contextlib.contextmanager
def swapped(pairs):
    """Set each (module, name) to its value; restore on exit."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def plain_path():
    """Swap every kernel wrapper for its plain version where the paths
    call it (the plain runs of the replays)."""
    from sdeflow_tpu_torch.models import common as mcommon, unet2d
    from sdeflow_tpu_torch.ops.kernels.attention import attention_math
    from sdeflow_tpu_torch.ops.kernels.attnblock import attn_block_math
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        circ_math, rk4_math_fwd, rk4_solve_select_math)
    from sdeflow_tpu_torch.ops.kernels.groupnorm import gn_math
    from sdeflow_tpu_torch.sde import msgm

    return swapped([(msgm, "circulant_apply", circ_math),
                    (msgm, "circulant_rk4_step", rk4_math_fwd),
                    (msgm, "circulant_rk4_solve_select",
                     rk4_solve_select_math),
                    (unet2d, "fused_attention_block", attn_block_math),
                    (mcommon, "group_norm_silu", gn_math),
                    (unet2d, "attention_core", attention_math)])


def direct_path():
    """Swap every kernel wrapper for a direct launch of its kernel, without
    its autograd.Function, where the serve path calls it (no_grad runs)."""
    from sdeflow_tpu_torch.models import common as mcommon, unet2d
    from sdeflow_tpu_torch.ops.kernels import (
        attention, attnblock, circulant, groupnorm)
    from sdeflow_tpu_torch.sde import msgm

    return swapped([
        (msgm, "circulant_apply", lambda s, y, w: circulant._launch_k1(
            circulant.sqrt_beta_column(s, y), y, w)),
        (unet2d, "fused_attention_block", attnblock._launch),
        (mcommon, "group_norm_silu", groupnorm._launch),
        (unet2d, "attention_core", attention._launch)])


def launch_counts():
    from sdeflow_tpu_torch.ops.kernels import common

    return {k.name: k.launches for k in common.KERNELS.values()}


def gn_mix(model, dev, x=None):
    """(C, S, silu) of every GroupNorm32 call of one forward on x (two
    grf16 latents unless given), counted."""
    from sdeflow_tpu_torch.models.common import GroupNorm32

    seen = collections.Counter()

    def hook(mod, inp):
        seen[(inp[0].shape[1], math.prod(inp[0].shape[2:]), mod.silu)] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, GroupNorm32)]
    try:
        with torch.no_grad():
            if x is None:
                x = torch.randn(2, DIM, device=dev)
            model(x, torch.rand(x.shape[0], device=dev))
    finally:
        for h in hooks:
            h.remove()
    return seen


def weighted(rows, key):
    """Mean of rows[i][key] per launch, each row weighted by its calls."""
    n = sum(r["calls_per_forward"] for r in rows)
    return sum(r[key] * r["calls_per_forward"] for r in rows) / n


def gn_args(g, dev, b, c, s, groups, dtype=torch.float32):
    return ((2.0 * torch.randn(b, c, s, generator=g, device=dev)
             + 0.5).to(dtype),
            1.0 + 0.1 * torch.randn(c, generator=g, device=dev),
            0.1 * torch.randn(c, generator=g, device=dev), groups)


def k5_rows(g, dev, mix, b, iters=50, dtype=torch.float32, device=False):
    """K5's times at each (C, S, silu) of a forward's GroupNorm mix at
    batch b with x in `dtype`, beside its plain version,
    torch.nn.functional.group_norm (on bf16 x with bf16 gamma and beta)
    and the bound; with `device`, also its device time per launch alone
    (a trace of direct launches)."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk

    size = torch.empty((), dtype=dtype).element_size()
    bound_fn = bound_ms if dtype == torch.float32 else bound_bf16_ms
    rows = []
    with torch.no_grad():
        for (c, s, silu), n in sorted(mix.items()):
            torch.cuda.empty_cache()  # each shape from a released cache
            x, gamma, beta, groups = a = gn_args(g, dev, b, c, s,
                                                 group_count(c), dtype)
            lg, lb = gamma.to(dtype), beta.to(dtype)
            bound, by = bound_fn(*k5_cost(b, c, s, silu, size))
            rows.append({
                "shape": [b, c, s], "silu": silu, "calls_per_forward": n,
                "ms": cuda_ms(lambda: gnk.group_norm_silu(*a, silu), iters),
                "direct_ms": cuda_ms(lambda: gnk._launch(*a, silu), iters),
                "plain_ms": cuda_ms(lambda: gnk.gn_math(*a, silu), iters),
                "library_ms": cuda_ms(lambda: torch.nn.functional.group_norm(
                    x, groups, lg, lb, eps=1e-5), iters),
                "bound_ms": bound, "bound_by": by})
            if device:
                rows[-1]["device_ms"] = device_times(
                    lambda: gnk._launch(*a, silu), SYMBOL["group_norm_silu"],
                    iters)[0]
            del x, gamma, beta, a
    return rows


def k5b_rows(g, dev, mix, b, iters=20, dtype=torch.float32):
    """K5's backward at each (C, S, silu) of a forward's GroupNorm mix at
    batch b: GroupNormSiLU's backward alone on a retained graph (kernel
    K5b), K5b as a direct launch, its plain version gn_math_vjp, the rule
    it replaced (autograd of the plain forward rerun on detached inputs),
    PyTorch's GroupNorm backward (aten.native_group_norm_backward, given
    the forward's statistics, without the SiLU) and the bound."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk

    aten = torch.ops.aten
    size = torch.empty((), dtype=dtype).element_size()
    bound_fn = bound_ms if dtype == torch.float32 else bound_bf16_ms
    rows = []
    for (c, s, silu), n in sorted(mix.items()):
        torch.cuda.empty_cache()  # each shape from a released cache
        x, gamma, beta, groups = gn_args(g, dev, b, c, s, group_count(c),
                                         dtype)
        dy = torch.randn(x.shape, generator=g, device=dev).to(dtype)
        ts = [t.requires_grad_() for t in (x, gamma, beta)]
        y = gnk.group_norm_silu(*ts, groups, silu)
        # PyTorch's GroupNorm backward as one call, given the forward's
        # statistics (no SiLU; gamma and beta in x's dtype)
        lg = gamma.detach().to(dtype)
        _, mean, rstd = aten.native_group_norm(x.detach(), lg,
                                               beta.detach().to(dtype), b, c,
                                               s, groups, 1e-5)

        def old():
            d = [t.detach().requires_grad_() for t in ts]
            return torch.autograd.grad(gnk.gn_math(*d, groups, silu), d, dy)

        bound, by = bound_fn(*k5b_cost(b, c, s, silu, size))
        row = {"shape": [b, c, s], "silu": silu, "calls_per_forward": n,
               "ms": cuda_ms(lambda: torch.autograd.grad(
                   y, ts, dy, retain_graph=True), iters),
               "old_ms": cuda_ms(old, iters),
               "bound_ms": bound, "bound_by": by}
        with torch.no_grad():
            row["library_ms"] = cuda_ms(
                lambda: aten.native_group_norm_backward(
                    dy, x, mean, rstd, lg, b, c, s, groups,
                    [True, True, True]), iters)
            row["direct_ms"] = cuda_ms(lambda: gnk._launch_vjp(
                x, gamma, beta, groups, silu, dy), iters)
            row["plain_ms"] = cuda_ms(lambda: gnk.gn_math_vjp(
                x, gamma, beta, groups, silu, dy), iters)
        rows.append(row)
        del x, gamma, beta, dy, ts, y, mean, rstd, lg
    return rows


def log_k5_rows(what, rows):
    for r in rows:
        old = f"old rule {r['old_ms']:.4f}, " if "old_ms" in r else ""
        dev = (f"device {r['device_ms']:.5f}, " if "device_ms" in r
               else "")
        log(f"{what} at {r['shape']} silu={r['silu']} "
            f"x{r['calls_per_forward']}: per call {r['ms']:.4f} ms, direct "
            f"{r['direct_ms']:.4f}, {dev}plain {r['plain_ms']:.4f}, {old}"
            f"PyTorch's {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
            "ms")


def check_k5(g, dev, mixes):
    """Phase 5: K5 against gn_math and K5b against gn_math_vjp at every
    GroupNorm shape of both grf16 routes (B = 1024) and of the DSM step
    (B = 128), and at odd sizes and the launch plans' edges; both timed at
    the auto route's shapes."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk

    grf = sorted({(c, s) for mix in mixes for c, s, _ in mix})
    dsm = sorted({(c, s) for c, s, _ in SGM_GN_MIX})
    cases = ([(N_SAMPLES, c, s, group_count(c)) for c, s in grf]
             + [(SGM_BATCH, c, s, group_count(c)) for c, s in dsm]
             + K5_ODD + K5_EDGES)
    worst = dict.fromkeys(("out", "dx", "dgamma", "dbeta", "dx_abs"), 0.0)
    with torch.no_grad():
        for b, c, s, groups in cases:
            a = gn_args(g, dev, b, c, s, groups)
            dy = torch.randn(b, c, s, generator=g, device=dev)
            for silu in (False, True):
                out = gnk.group_norm_silu(*a, silu)
                grads = gnk._launch_vjp(*a, silu, dy)
                torch.cuda.synchronize()
                ref = gnk.gn_math(*a, silu)
                torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
                worst["out"] = max(worst["out"],
                                   (out - ref).abs().max().item())
                del out, ref
                # dx against the fp32 plain vjp; dγ, dβ (sums of B·S terms)
                # against the float64 one
                ref_dx = gnk.gn_math_vjp(*a, silu, dy)[0]
                ref64 = gnk.gn_math_vjp(*(t.double() for t in a[:3]),
                                        groups, silu, dy.double())[1:]
                for name, got, want in zip(("dx", "dgamma", "dbeta"), grads,
                                           (ref_dx, *ref64)):
                    scale = want.abs().max().item()
                    torch.testing.assert_close(
                        got.to(want.dtype), want, rtol=1e-5,
                        atol=1e-5 * scale)
                    err = (got.to(want.dtype) - want).abs().max().item()
                    worst[name] = max(worst[name], err / scale)
                    if name == "dx":
                        worst["dx_abs"] = max(worst["dx_abs"], err)
                del grads, ref_dx, ref64
            del a, dy
    log(f"K5 and K5b at {len(cases)} shapes (B = {N_SAMPLES}: {grf}; B = "
        f"{SGM_BATCH}: {dsm}; odd {K5_ODD}; edges {K5_EDGES}), SiLU on and "
        f"off: K5 max |kernel - plain| = {worst['out']:.3g} (tolerance "
        f"1e-5); K5b max |Δ| / max |plain|: dx {worst['dx']:.3g}, dγ "
        f"{worst['dgamma']:.3g} and dβ {worst['dbeta']:.3g} against the "
        "float64 plain vjp (tolerance 1e-5)")
    rows = k5_rows(g, dev, mixes[0], N_SAMPLES)
    log_k5_rows("K5", rows)
    rows_b = k5b_rows(g, dev, mixes[0], N_SAMPLES)
    log_k5_rows("K5b", rows_b)
    return {"max_abs_err": worst["out"], "per_shape": rows,
            "bwd_max_abs_err": worst["dx_abs"],
            "bwd_max_rel_err": {k: worst[k] for k in ("dx", "dgamma",
                                                      "dbeta")},
            "bwd_per_shape": rows_b}


def sdpa_args(qkv, heads):
    """q, k, v as (B, H, T, ch) from the interleaved qkv (B, T, 3C)."""
    b, t, c3 = qkv.shape
    ch = c3 // 3 // heads
    return [a.permute(0, 2, 1, 3).contiguous() for a in
            qkv.reshape(b, t, heads, 3 * ch).split(ch, dim=-1)]


def check_k6(g, dev):
    """Phase 6: K6 (and K4, T > 1024) against attention_math; times with
    one head at the path's shapes and at (4, 4096, 64)."""
    from sdeflow_tpu_torch.ops.kernels import attention as ak

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, long_err = {}, 0.0
    with torch.no_grad():
        for b, t, c, heads in K6_SHAPES + K4_SHAPES:
            qkv = 1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)
            out = ak.qkv_attention(qkv, heads)
            torch.cuda.synchronize()
            ref = ak.attention_math(qkv, heads)
            tol = 2e-5 if t > 1024 else 1e-5
            if (t, c) == K6_DSM:
                # here the fp32 plain version is itself about 1e-5 from the
                # float64 one: hold the kernel to the plain version run in
                # float64, and print how far the fp32 one is
                ref32 = ref
                ref = ak.attention_math(qkv.double(), heads).float()
                log(f"  plain fp32 at {[b, t, c]}: max |plain - float64| = "
                    f"{(ref32 - ref).abs().max().item():.3g}")
                del ref32
            torch.testing.assert_close(out, ref, rtol=0, atol=tol)
            err = (out - ref).abs().max().item()
            if t > 1024:
                long_err = max(long_err, err)
            log(f"{'K4' if t > 1024 else 'K6'} ({b}, {t}, {c}) heads={heads}:"
                f" max |kernel - plain| = {err:.3g} (tolerance {tol:g})")
            if heads != 1 or (b, t, c, heads) == K4_SHAPES[2]:
                continue
            iters = 50 if b * t * t <= 2**24 else 10
            q, k, v = sdpa_args(qkv, heads)
            lib = sdpa(q, k, v).permute(0, 2, 1, 3).reshape(b, t, c)
            bound, by = bound_ms(*k6_cost(b, t, c, heads))
            rows[(t, c)] = {
                "shape": [b, t, c], "heads": heads, "max_abs_err": err,
                "library_max_abs_diff": (lib - ref).abs().max().item(),
                "ms": cuda_ms(lambda: ak.qkv_attention(qkv, heads), iters),
                "direct_ms": cuda_ms(lambda: ak._launch(qkv, heads), iters),
                "plain_ms": cuda_ms(lambda: ak.attention_math(qkv, heads),
                                    iters),
                "library_ms": cuda_ms(lambda: sdpa(q, k, v), iters),
                "bound_ms": bound, "bound_by": by}
            r = rows[(t, c)]
            log(f"{'K4' if t > 1024 else 'K6'} at {[b, t, c]}: direct "
                f"{r['direct_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
    rows[K4_SHAPES[0][1:3]]["max_abs_err"] = long_err  # over every K4 shape
    return rows


def timed_row(kern, plan, fn, direct, plain, args, cost):
    """K1's or K2's row at the shape (B, d) of args[1]: its time per call
    through the Function (fn), as a direct launch and of its plain
    version (CUDA events over 200 calls), its device time alone and the
    launch floor from traces, and its bound."""
    b, d = args[1].shape
    dev_ms, floor, _ = device_times(lambda: direct(*args), SYMBOL[kern.name])
    bound = bound_ms(*cost(b, d))
    return {"shape": [b, d], "plan": plan._asdict(),
            "ms": cuda_ms(lambda: fn(*args), 200),
            "direct_ms": cuda_ms(lambda: direct(*args), 200),
            "plain_ms": cuda_ms(lambda: plain(*args), 200),
            "device_ms_alone": dev_ms, "floor_ms": floor,
            "bound_ms": bound[0], "bound_by": bound[1]}


def check_k1(g, dev):
    """Phase 2: K1 against its plain version at every plan's edge, bit for
    bit, with the Python plan mirror held to the compiled chooser; its
    times at the serve shape."""
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K1, _launch_k1, circ_math, circulant_apply, circulant_plan,
        kernel_plan)

    row = {}
    with torch.no_grad():
        for b, d in K1_SHAPES:
            plan = circulant_plan(b, d)
            if kernel_plan(K1, b, d) != plan:
                raise AssertionError(f"K1 ({b}, {d}): plan mirror {plan} != "
                                     f"{kernel_plan(K1, b, d)}")
            y = torch.randn(b, d, generator=g, device=dev)
            w = torch.randn(b, d, generator=g, device=dev)
            sb = 1.0 + torch.rand(b, 1, generator=g, device=dev)
            out = circulant_apply(sb, y, w)
            torch.cuda.synchronize()
            ref = circ_math(sb, y, w)
            err = (out - ref).abs().max().item()
            log(f"K1 ({b}, {d}) {plan.kind} plan ({plan.per_lane} floats per "
                f"lane, vec {plan.vec}): max |kernel - plain| = {err:.3g}")
            if not torch.equal(out, ref):
                raise AssertionError(f"K1 ({b}, {d}) differs from circ_math")
            if (b, d) == (N_SAMPLES, DIM):
                row = dict(timed_row(K1, plan, circulant_apply, _launch_k1,
                                     circ_math, (sb, y, w), k1_cost),
                           max_abs_err=err)
    log(f"K1 at {row['shape']}: device {row['device_ms_alone']:.5f} ms "
        f"(launch floor {row['floor_ms']:.5f} ms), bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}), per call "
        f"{row['ms']:.4f} ms, direct {row['direct_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms")
    return row


def forward_select(gen, g, b, n):
    """Steps per sample of the SSM loss's forward solve, from the arm's t
    draws as sample_scheme makes them."""
    t = gen.sample_t(g, b)
    sel = torch.clamp(torch.floor(n * t / gen.base_sde.T).long(), 0, n)
    return torch.where(t >= gen.base_sde.T, n, sel)


def step_loop(flow, x0, g, n, sel, z=None):
    """integrate_select's per-step loop as it ran before the whole-solve
    override: per step a draw of normals (unless z gives them), the √δ
    scale, ForwardFlow.rk4_step (three fills of sb3 and kernel K2) and the
    masked select."""
    delta = float(flow.T) / n
    sqrt_delta = delta ** 0.5
    sel = sel.reshape(-1, 1)
    x = kept = x0
    for i in range(n):
        zi = z[i] if z is not None else torch.randn(
            x0.shape, generator=g, device=x0.device)
        x = flow.rk4_step(i * delta, x, delta, sqrt_delta * zi)
        kept = torch.where(sel == i + 1, x, kept)
    return kept


def check_k2(gen, g, dev):
    """Phase 12: K2 against its plain version at every plan's edge, bit for
    bit, with the plan mirror held to the compiled chooser, its times at
    the training shape, the forward flow's fused step against the generic
    stages on the plain versions, and K2's solve (check_solve)."""
    from sdeflow_tpu_torch.ops.integrators import rk4_step
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K2, _launch_k2, circulant_rk4_step, kernel_plan, rk4_math_fwd,
        rk4_plan)
    from sdeflow_tpu_torch.sde import ForwardFlow

    row = {}
    delta = 1.0 / TRAIN_STEPS
    with torch.no_grad():
        for b, d in K2_SHAPES:
            plan = rk4_plan(b, d)
            if kernel_plan(K2, b, d) != plan:
                raise AssertionError(f"K2 ({b}, {d}): plan mirror {plan} != "
                                     f"{kernel_plan(K2, b, d)}")
            x = torch.randn(b, d, generator=g, device=dev)
            w = delta**0.5 * torch.randn(b, d, generator=g, device=dev)
            sb3 = 1.0 + torch.rand(b, 3, generator=g, device=dev)
            out = circulant_rk4_step(sb3, x, w)
            torch.cuda.synchronize()
            ref = rk4_math_fwd(sb3, x, w)
            err = (out - ref).abs().max().item()
            log(f"K2 ({b}, {d}) {plan.kind} plan ({plan.per_lane} floats per "
                f"lane, vec {plan.vec}): max |kernel - plain| = {err:.3g}")
            if not torch.equal(out, ref):
                raise AssertionError(f"K2 ({b}, {d}) differs from "
                                     "rk4_math_fwd")
            if (b, d) == (TRAIN_BATCH, DIM):
                row = dict(timed_row(K2, plan, circulant_rk4_step, _launch_k2,
                                     rk4_math_fwd, (sb3, x, w), k2_cost),
                           max_abs_err=err)
        log(f"K2 at {row['shape']}: device {row['device_ms_alone']:.5f} ms "
            f"(launch floor {row['floor_ms']:.5f} ms), bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}), per call "
            f"{row['ms']:.4f} ms, direct {row['direct_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms")
        flow = ForwardFlow(base_sde=gen.base_sde, T=gen.base_sde.T)
        x = gen.latent_sample(g, TRAIN_BATCH)
        dw = delta**0.5 * torch.randn(x.shape, generator=g, device=dev)
        for t in (0.0, 0.5, 1.0 - delta):
            fused = flow.rk4_step(t, x, delta, dw)
            with plain_path():
                generic = rk4_step(flow, t, x, delta, dw)
            torch.testing.assert_close(fused, generic, rtol=1e-6, atol=1e-6)
            log(f"ForwardFlow.rk4_step at t={t:.4f} (K2) vs generic stages "
                f"(plain): max |Δ| = {(fused - generic).abs().max().item():.3g}")
    return row, check_solve(gen, g, dev)


def check_solve(gen, g, dev, b=TRAIN_BATCH, dim=DIM, steps=TRAIN_STEPS,
                what="grf16"):
    """K2's solve at the SSM loss's shape (by default grf16's (64, 128,
    256)) on the arm's SDE, with the steps per row from the arm's t draws
    and the edge cases (all 0, all n): bit for bit against step_loop on the same normals (a K2 launch
    per step), within 1e-6 of rk4_solve_select_math; its device time per
    select case (the per-row step counts beside it: rows near 64 set a
    latency-bound launch); then against the loop: device time from traces
    and wall time per solve with the loop's draws, fills and selects."""
    from sdeflow_tpu_torch.ops.integrators import integrate_select
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K2, K2_SOLVE, _launch_solve, circulant_rk4_solve_select, kernel_plan,
        rk4_plan, rk4_solve_select_math)
    from sdeflow_tpu_torch.sde import ForwardFlow
    from sdeflow_tpu_torch.sde.msgm import sqrt_beta_table

    sde = gen.base_sde
    n = sde.num_steps_forward
    if n != steps:
        raise AssertionError(f"{what}'s forward solve takes {n} steps")
    if kernel_plan(K2, b, dim) != rk4_plan(b, dim):
        raise AssertionError("K2's plan mirror differs at the solve's shape")
    flow = ForwardFlow(base_sde=sde, T=sde.T)
    delta = float(sde.T) / n
    sd = delta ** 0.5
    sb = sqrt_beta_table(sde.beta_min, sde.beta_max, delta, n, dev,
                         torch.float32)
    x0 = gen.latent_sample(g, b)
    z = torch.randn(n, b, dim, generator=g, device=dev)
    drawn = f"{what} t draws"
    cases = {drawn: forward_select(gen, g, b, n),
             "all 0": torch.zeros(b, dtype=torch.int64, device=dev),
             f"all {n}": torch.full((b,), n, dtype=torch.int64, device=dev)}
    rec = {"shape": [n, b, dim], "plan": rk4_plan(b, dim)._asdict(),
           "cases": {}}
    with torch.no_grad():
        for name, sel in cases.items():
            before = K2_SOLVE.launches
            got = circulant_rk4_solve_select(x0, z, sb, sel, sd)
            torch.cuda.synchronize()
            if K2_SOLVE.launches != before + 1:
                raise AssertionError("the solve did not launch once")
            loop = step_loop(flow, x0, None, n, sel, z)
            via = integrate_select(flow, x0, None, n, sel, noise=z)
            plain = rk4_solve_select_math(x0, z, sb, sel, sd)
            err_loop = (got - loop).abs().max().item()
            err_plain = (got - plain).abs().max().item()
            if not (torch.equal(got, loop) and torch.equal(via, got)):
                raise AssertionError(f"solve ({name}) differs from the K2 "
                                     f"loop: {err_loop:.3g}")
            torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)
            dev_ms, floor, _ = device_times(
                lambda: _launch_solve(x0, z, sb, sel, sd), SYMBOL[K2_SOLVE.name])
            bound = bound_ms(*solve_cost(sel, dim, n))
            rec["cases"][name] = {
                "max_abs_err_loop": err_loop, "max_abs_err": err_plain,
                "steps_max": int(sel.max().item()),
                "steps_mean": sel.double().mean().item(),
                "device_ms": dev_ms, "floor_ms": floor,
                "bound_ms": bound[0], "bound_by": bound[1]}
            log(f"K2 solve {tuple(rec['shape'])}, {name} (steps per row: max "
                f"{int(sel.max())}, mean {sel.double().mean().item():.2f}): "
                f"max |solve - K2 loop| = {err_loop:.3g}, max |solve - plain| "
                f"= {err_plain:.3g}; device {dev_ms:.5f} ms (launch floor "
                f"{floor:.5f} ms), bound {bound[0]:.5f} ms ({bound[1]})")
        sel = cases[drawn]
        rec.update(rec["cases"][drawn])
        rec["ms"] = cuda_ms(lambda: circulant_rk4_solve_select(
            x0, z, sb, sel, sd), 100)
        rec["direct_ms"] = cuda_ms(lambda: _launch_solve(x0, z, sb, sel, sd),
                                   100)
        rec["plain_ms"] = cuda_ms(lambda: rk4_solve_select_math(
            x0, z, sb, sel, sd), 5, 1)
        rec["loop_ms"] = cuda_ms(lambda: step_loop(flow, x0, None, n, sel, z),
                                 5, 1)
        # with the draws: the override's one randn, the loop's 64
        rec["solve_wall_ms"] = cuda_ms(lambda: integrate_select(
            flow, x0, g, n, sel), 20, 2)
        rec["loop_wall_ms"] = cuda_ms(lambda: step_loop(flow, x0, g, n, sel),
                                      5, 1)
        # device time and kernels per solve, with the draws
        rec["solve_device_ms"], rec["solve_kernels"] = device_per_call(
            lambda: integrate_select(flow, x0, g, n, sel), 20)
        rec["loop_device_ms"], rec["loop_kernels"] = device_per_call(
            lambda: step_loop(flow, x0, g, n, sel), 5)
    log(f"K2 solve vs the per-step K2 loop on the same normals: per call "
        f"{rec['ms']:.4f} ms (direct {rec['direct_ms']:.4f}), loop "
        f"{rec['loop_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms; with the "
        f"draws {rec['solve_wall_ms']:.4f} against {rec['loop_wall_ms']:.3f} "
        f"ms per solve, device time {rec['solve_device_ms']:.4f} ms in "
        f"{rec['solve_kernels']:g} kernels against "
        f"{rec['loop_device_ms']:.4f} ms in {rec['loop_kernels']:g}")
    return rec


def check_trajectory(gen, g, dev):
    """Phase 14's forward trajectory (sample_scheme_allt, the ssm_intT
    loss's solve, K2's step path) at batch 128: exactly one K2 step launch
    per forward step and no solve; with injected normals its last state
    equals K2's solve taking every step, bit for bit."""
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        circulant_rk4_solve_select)
    from sdeflow_tpu_torch.sde.msgm import sqrt_beta_table

    sde = gen.base_sde
    n, b = sde.num_steps_forward, TRAIN_BATCH
    x0 = gen.latent_sample(g, b)
    want = {k.name: 0 for k in common.KERNELS.values()}
    want["circulant_rk4_step"] = n
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = sde.sample_scheme_allt(g, x0, include_t0=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    if counts != want:
        raise AssertionError(f"forward trajectory launched {counts}")
    if tuple(traj.shape) != (n, b, DIM) or not torch.isfinite(traj).all():
        raise AssertionError(f"bad trajectory {tuple(traj.shape)}")
    z = torch.randn(n, b, DIM, generator=g, device=dev)
    delta = float(sde.T) / n
    with torch.no_grad():
        last = sde.sample_scheme_allt(None, x0, include_t0=False, noise=z)[-1]
        solve = circulant_rk4_solve_select(
            x0, z, sqrt_beta_table(sde.beta_min, sde.beta_max, delta, n, dev,
                                   torch.float32),
            torch.full((b,), n, dtype=torch.int64, device=dev), delta ** 0.5)
    if not torch.equal(last, solve):
        raise AssertionError("the trajectory's last state differs from the "
                             "solve's")
    log(f"forward trajectory ({n}, {b}, {DIM}): {dt * 1e3:.2f} ms, launches "
        f"{counts}, last state equal to K2's solve")
    return {"ms": dt * 1e3, "launches": counts}


def through_autograd(fn, args, seed):
    """fn's jvp (random tangents on every argument) and the gradients of
    sum(fn(args)·c) for a random cotangent c."""
    gen = torch.Generator(device=args[0].device).manual_seed(seed)

    def draw(a):
        return torch.randn(a.shape, generator=gen, device=a.device)

    out, tan = torch.func.jvp(fn, tuple(args), tuple(map(draw, args)))
    diff = [a.detach().requires_grad_() for a in args]
    grads = torch.autograd.grad((fn(*diff) * draw(out)).sum(), diff)
    return (out, tan, *grads)


def block_args(g, dev, b, t, c):
    return [2.0 * torch.randn(b, t, c, generator=g, device=dev) + 0.5,
            1.0 + 0.1 * torch.randn(c, generator=g, device=dev),
            0.1 * torch.randn(c, generator=g, device=dev),
            torch.randn(c, 3 * c, generator=g, device=dev) / c**0.5,
            0.1 * torch.randn(3 * c, generator=g, device=dev),
            torch.randn(c, c, generator=g, device=dev) / c**0.5,
            0.1 * torch.randn(c, generator=g, device=dev)]


def double_backward(fn, args, seed):
    """∂/∂args of <∂L/∂args[0], v> with L = Σ c·fn(args)² (c, v random):
    a second reverse pass, through create_graph."""
    gen = torch.Generator(device=args[0].device).manual_seed(seed)
    xs = [a.detach().requires_grad_() for a in args]
    out = fn(*xs)
    cot = torch.randn(out.shape, generator=gen, device=out.device)
    (g0,) = torch.autograd.grad((cot * out**2).sum(), xs[0],
                                create_graph=True)
    v = torch.randn(g0.shape, generator=gen, device=g0.device)
    return torch.autograd.grad((g0 * v).sum(), xs, allow_unused=True,
                               materialize_grads=True)


def check_autograd(g, dev):
    """Phase 13: jvp, grad and a double backward through each kernel's
    Function (kernel forward, plain rules; the second pass through the
    differentiable plain backward) against the plain version; a ResBlock's
    gradient through its JVP on cuDNN and K5 against the CPU."""
    from sdeflow_tpu_torch.models.unet2d import ResBlock
    from sdeflow_tpu_torch.ops.kernels.attention import (
        attention_math, qkv_attention)
    from sdeflow_tpu_torch.ops.kernels.attnblock import (
        attn_block_math, fused_attention_block)
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        circ_math, circulant_apply, circulant_rk4_solve_select,
        circulant_rk4_step, rk4_math_fwd, rk4_solve_select_math)
    from sdeflow_tpu_torch.ops.kernels.groupnorm import (
        K5B, gn_math, group_norm_silu)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    b, d = TRAIN_BATCH, DIM
    cases = [
        ("K1", circulant_apply, circ_math,
         [1.0 + rnd(b, 1).abs(), rnd(b, d), rnd(b, d)], 1e-6),
        ("K2", circulant_rk4_step, rk4_math_fwd,
         [1.0 + rnd(b, 3).abs(), rnd(b, d), 0.125 * rnd(b, d)], 1e-6)]
    # K2's solve over 8 steps, rows taking 0 to 8 of them
    sel = torch.randint(0, 9, (b,), generator=g, device=dev)
    cases.append(("K2 solve",
                  lambda *a: circulant_rk4_solve_select(*a, sel, 0.125),
                  lambda *a: rk4_solve_select_math(*a, sel, 0.125),
                  [rnd(b, d), rnd(8, b, d), 1.0 + rnd(8, 3).abs()], 1e-6))
    for t, c in BLOCK_MIX:
        cases.append((f"K3 ({b}, {t}, {c})",
                      lambda *a: fused_attention_block(*a, 32, 1),
                      lambda *a: attn_block_math(*a, 32, 1),
                      block_args(g, dev, b, t, c), 1e-5))
        cases.append((f"K6 ({b}, {t}, {c})",
                      lambda q: qkv_attention(q, 1),
                      lambda q: attention_math(q, 1),
                      [1.5 * rnd(b, t, 3 * c)], 1e-5))
    for c, s, silu in [(32, 256, True), (192, 16, True), (64, 64, False)]:
        cases.append((f"K5 ({b}, {c}, {s}) silu={silu}",
                      lambda *a, silu=silu: group_norm_silu(*a, 32, silu),
                      lambda *a, silu=silu: gn_math(*a, 32, silu),
                      [2.0 * rnd(b, c, s) + 0.5, 1.0 + 0.1 * rnd(c),
                       0.1 * rnd(c)], 1e-5))
    errs = {}
    for name, kern, plain, args, tol in cases:
        before = K5B.launches
        got = through_autograd(kern, args, 1) + double_backward(kern, args, 2)
        # K5's gradient (grad mode off) through K5b, and the double
        # backward's second pass, which reaches the Function's output
        # through the cotangent c·2·out (its own second-order terms run
        # through the plain version's differentiable vjp)
        if K5B.launches - before != 2 * name.startswith("K5"):
            raise AssertionError(f"{name}: K5b launched "
                                 f"{K5B.launches - before} times")
        want = (through_autograd(plain, args, 1)
                + double_backward(plain, args, 2))
        worst = 0.0
        for a, w in zip(got, want):  # output, tangent, gradients, second
            scale = max(w.abs().max().item(), 1e-30)
            torch.testing.assert_close(a, w, rtol=tol, atol=tol * scale)
            worst = max(worst, (a - w).abs().max().item() / scale)
        errs[name] = worst
        log(f"{name} through jvp, grad and double backward: max |Δ| / "
            f"max |plain| = {worst:.3g} (tolerance {tol:g})")
    # reverse over forward through cuDNN's convolutions and K5, fp32
    # without TF32
    torch.manual_seed(0)
    block = ResBlock(64, 128)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    xs, emb = torch.randn(16, 64, 8, 8), torch.randn(16, 128)
    vs = torch.randn_like(xs)

    def grads(m, *a):
        _, tan = torch.func.jvp(lambda z: m(z, a[1]), (a[0],), (a[2],))
        return torch.autograd.grad((tan * a[2]).sum(), list(m.parameters()),
                                   allow_unused=True, materialize_grads=True)

    ref = grads(block, xs, emb, vs)
    got = grads(block.to(dev), xs.to(dev), emb.to(dev), vs.to(dev))
    gmax = max(r.abs().max().item() for r in ref)
    # the output bias does not reach the tangent: its gradient is 0
    worst = max((a.cpu() - r).abs().max().item()
                / max(r.abs().max().item(), 1e-6 * gmax)
                for a, r in zip(got, ref))
    log(f"ResBlock grad of its JVP, cuDNN and K5 vs CPU: max |Δ| / max |g| "
        f"= {worst:.3g} (tolerance 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"ResBlock reverse over forward: {worst:.3g}")
    errs["ResBlock"] = worst
    return errs


def train_draws(gen, sampler, g, dev):
    from sdeflow_tpu_torch.ops.hutchinson import sample_v

    b = TRAIN_BATCH
    x = sampler.sample(g, b)
    return x, dict(
        t=gen.sample_t(g, b),
        noise=torch.randn(TRAIN_STEPS, b, DIM, generator=g, device=dev),
        noise_one=torch.randn(b, DIM, generator=g, device=dev),
        v=sample_v(g, (b, DIM), gen.vtype, device=dev))


def train_agreement(model, per_sample, g, x, draws, want, loss_tol=1e-4,
                    grad_tol=1e-3, exact=None, bf16_only=False):
    """On one batch with injected draws: the kernel path's loss
    (per_sample(g, x, **draws).mean(), the SSM or DSM loss) and every
    parameter gradient against the plain path's (loss within loss_tol
    relative, each gradient within grad_tol·max |g| of its own tensor, or
    of all tensors where the gradient is zero in exact arithmetic: below
    1e-6 of the largest), the kernel path's exact launch counts, and each
    path's peak memory. With `exact` (a path in bf16: the gradients of the
    same loss computed in fp32), each gradient is held to grad_tol times
    the largest gradient of the loss instead, and both paths' distances
    from the fp32 gradients are recorded: in bf16 a tensor's gradient lies
    up to tens of percent of its own largest entry from the fp32 one on
    either path (they round at other places: the kernels' tangents are
    fp32 closed forms, the plain path's forward-mode AD of bf16
    operations), so two bf16 paths cannot be compared tensor by tensor.
    With bf16_only, the kernel path must launch no float32 entry of the
    attention kernels."""
    from sdeflow_tpu_torch.ops.kernels import common

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = per_sample(g, x, **draws).mean()
        loss.backward()
        torch.cuda.synchronize()
        peak.append(torch.cuda.max_memory_allocated())
        return loss.detach(), {n: p.grad.detach().clone()
                               for n, p in model.named_parameters()}

    peak = []
    common.reset_launches()
    loss_k, grads_k = loss_and_grads()
    if launch_counts() != want or (bf16_only and f32_attention_launches()):
        raise AssertionError(f"kernel loss launched {launch_counts()}, "
                             f"{entry_counts()}")
    common.reset_launches()
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    if any(launch_counts().values()):
        raise AssertionError(f"plain loss launched {launch_counts()}")
    model.zero_grad(set_to_none=True)
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    gmax = max(v.abs().max().item() for v in grads_p.values())
    worst, worst_name, dead = 0.0, None, 0
    for n, gp in grads_p.items():
        scale = gp.abs().max().item() if exact is None else gmax
        if scale < 1e-6 * gmax:  # no gradient in exact arithmetic
            scale, dead = gmax, dead + 1
        ratio = (grads_k[n] - gp).abs().max().item() / scale
        if ratio > worst:
            worst, worst_name = ratio, n
    what = "max |g| of its tensor" if exact is None else "max |g| of all"
    log(f"train loss kernel {loss_k.item():.6f}, plain {loss_p.item():.6f} "
        f"(rel {rel_loss:.3g}, tolerance {loss_tol:g}); worst gradient max "
        f"|Δ| / {what} = {worst:.3g} at {worst_name} (tolerance "
        f"{grad_tol:g}; {dead} of {len(grads_p)} tensors have no gradient "
        f"in exact arithmetic); peak memory kernel {peak[0] / 2**20:.1f} "
        f"MiB, plain {peak[1] / 2**20:.1f} MiB")
    rec = {"loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
           "loss_rel": rel_loss, "grad_worst_rel": worst,
           "grad_worst": worst_name, "grad_tensors": len(grads_p),
           "grad_tensors_zero": dead, "peak_memory_kernel": peak[0],
           "peak_memory_plain": peak[1]}
    if exact is not None:
        ref = torch.cat([v.flatten() for v in exact.values()])
        for k, gr in (("kernel", grads_k), ("plain", grads_p)):
            d = torch.cat([v.flatten() for v in gr.values()]) - ref
            rec[f"{k}_fp32_rel_l2"] = (d.norm() / ref.norm()).item()
            rec[f"{k}_fp32_worst"] = max(
                (gr[n] - exact[n]).abs().max().item()
                / max(exact[n].abs().max().item(), 1e-30) for n in exact
                if exact[n].abs().max().item() >= 1e-6 * ref.abs().max())
        log(f"  against the fp32 gradient: kernel path |Δ|/|g| "
            f"{rec['kernel_fp32_rel_l2']:.3g} (worst tensor "
            f"{rec['kernel_fp32_worst']:.3g} of its max), plain path "
            f"{rec['plain_fp32_rel_l2']:.3g} ({rec['plain_fp32_worst']:.3g})")
    if not (torch.isfinite(loss_k) and rel_loss <= loss_tol
            and worst <= grad_tol):
        raise AssertionError("kernel and plain training paths disagree")
    return rec


def timed_train_steps(step, model, n, want, batch=TRAIN_BATCH):
    """n bare train steps, each with exactly `want` launches; ms per step,
    peak memory, the losses, and that the parameters moved."""
    from sdeflow_tpu_torch.ops.kernels import common

    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    losses, counts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(step())
        counts.append(launch_counts())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    if any(c != want for c in per_step):
        raise AssertionError(f"launches per train step {per_step} != {want}")
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError("non-finite training loss")
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(model.parameters(), before))
    if not moved > 0:
        raise AssertionError("the parameters did not move")
    rec = dict(ms_per_step=dt * 1e3 / n, steps_per_s=n / dt,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches_per_step=per_step[-1],
               losses=[v.item() for v in losses], param_moved=moved)
    log(f"{n} train steps at batch {batch}: {rec['ms_per_step']:.2f} "
        f"ms/step, {rec['steps_per_s']:.2f} steps/s, peak memory "
        f"{rec['max_memory_allocated'] / 2**20:.1f} MiB, launches per step "
        f"{per_step[-1]}, loss {losses[0].item():.3f} -> "
        f"{losses[-1].item():.3f}")
    return rec


def check_training(cfg, model, gen, g, dev):
    """Phase 14: the kernel path against the plain path on one batch, the
    driver's Trainer, timed bare train steps with their launch counts, and
    the plain, kernel, kernel, plain replay of a train step."""
    from sdeflow_tpu_torch import train_msgm_arm
    from sdeflow_tpu_torch.experiments.driver import make_sampler
    from sdeflow_tpu_torch.ops.kernels import common

    b = cfg.sweep.batch_sizes[0]
    if (b, cfg.train.num_steps_forward) != (TRAIN_BATCH, TRAIN_STEPS):
        raise AssertionError("grf16 trains at batch 128 with 64 steps")
    want = train_want("auto")
    assert set(want) == set(common.KERNELS)
    sampler = make_sampler(cfg, DIM, dev)
    x, draws = train_draws(gen, sampler, g, dev)
    rec = {"agreement": train_agreement(model, gen.ssm, g, x, draws, want)}

    # the driver's Trainer: three steps with ELBO prints at 1 and 3
    t0 = time.perf_counter()
    trainer, _, loss = train_msgm_arm(cfg, g, iterations=WARM_STEPS,
                                      arm=(model, gen), x_test=x, device=dev,
                                      log_fn=log)
    torch.cuda.synchronize()
    rec["trainer_s"] = time.perf_counter() - t0
    if not (trainer.state.step == WARM_STEPS and math.isfinite(loss)):
        raise AssertionError(f"Trainer: step {trainer.state.step}, {loss}")

    def step():
        xb = sampler.sample(g, b)
        return trainer.train_step(trainer.state, g, xb)[1]

    rec.update(timed_train_steps(step, model, TIMED_STEPS, want))

    replay = []
    for mode in ("plain", "kernel", "kernel", "plain"):
        ctx = plain_path() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            common.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REPLAY_STEPS):
                step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        expect = {k: (n * REPLAY_STEPS if mode == "kernel" else 0)
                  for k, n in want.items()}
        if launch_counts() != expect:
            raise AssertionError(f"{mode} replay launched {launch_counts()}")
        replay.append({"mode": mode, "ms_per_step": dt * 1e3 / REPLAY_STEPS})
        log(f"{mode} train replay: {dt * 1e3 / REPLAY_STEPS:.2f} ms/step")
    rec["replay"] = replay
    return rec, step


def serve_runs(sample, g, x0, noise, ref, modes, want):
    """Runs of `sample` on x0 and noise in the given modes ("kernel",
    "direct", "plain"): launches exactly `want` (none when plain), and
    max |ref - run| ≤ 1e-3·max |run|."""
    from sdeflow_tpu_torch.ops.kernels import common

    swaps = {"plain": plain_path, "direct": direct_path,
             "kernel": contextlib.nullcontext}
    runs = []
    for mode in modes:
        with swaps[mode]():
            common.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_r = sample(g, x0=x0, noise=noise)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launched = launch_counts()
        if launched != (want if mode != "plain" else
                        {k: 0 for k in launched}):
            raise AssertionError(f"{mode} replay launched {launched}")
        rel = ((ref - x_r).abs().max() / x_r.abs().max()).item()
        log(f"{mode} replay: {dt * 1e3:.1f} ms; max |request - replay| / "
            f"max |x| = {rel:.3g}")
        if not rel <= 1e-3:
            raise AssertionError(f"{mode} replay disagrees: {rel:.3g}")
        runs.append({"mode": mode, "ms": dt * 1e3, "rel_err": rel})
    return runs


def in_turns(fns, reps=1):
    """Wall ms per call of fns["auto"] and fns["unfused"], in the turns
    auto, unfused, unfused, auto (each turn `reps` calls)."""
    out = {k: [] for k in fns}
    for k in ("auto", "unfused", "unfused", "auto"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fns[k]()
        torch.cuda.synchronize()
        out[k].append((time.perf_counter() - t0) * 1e3 / reps)
    log(f"in turns, ms per call: auto {out['auto']}, unfused "
        f"{out['unfused']}")
    return out


def serve_unfused(cfg, gen_u, g, dev, x0, noise, x_auto, sample_auto):
    """Phase 10: one request on the unfused route, its replays, the two
    routes' requests in turns, and a traced 2-step request."""
    from sdeflow_tpu_torch import make_sampler_fn
    from sdeflow_tpu_torch.ops.kernels import common

    want = serve_want("unfused")
    sample = make_sampler_fn(gen_u, N_SAMPLES, DIM, STEPS,
                             method=cfg.sweep.backward_method,
                             norm_correction=True, device=dev)
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = sample(g, x0=x0, noise=noise)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    if not torch.isfinite(x).all() or tuple(x.shape) != (N_SAMPLES, DIM):
        raise AssertionError(f"unfused request: bad samples {tuple(x.shape)}")
    torch.testing.assert_close(x.norm(dim=1), x0.norm(dim=1), rtol=1e-5,
                               atol=0)
    if launches != want:
        raise AssertionError(f"unfused request: launches {launches} != {want}")
    rel = ((x - x_auto).abs().max() / x_auto.abs().max()).item()
    log(f"unfused request: {dt * 1e3:.1f} ms, {N_SAMPLES / dt:.1f} samples/s,"
        f" launches {launches}; max |unfused - auto| / max |x| = {rel:.3g}")
    if not rel <= 1e-3:
        raise AssertionError(f"the unfused and auto routes disagree: {rel:.3g}")
    rec = {"request": {"ms": dt * 1e3, "samples_per_s": N_SAMPLES / dt,
                       "launches": launches, "rel_to_auto": rel}}
    rec["replay"] = serve_runs(sample, g, x0, noise, x, (
        "plain", "kernel", "direct", "direct", "kernel", "plain"), want)
    rec["in_turns"] = in_turns({
        "auto": lambda: sample_auto(g, x0=x0, noise=noise),
        "unfused": lambda: sample(g, x0=x0, noise=noise)})
    sample2 = make_sampler_fn(gen_u, N_SAMPLES, DIM, PROFILED_STEPS,
                              method="rk4", norm_correction=True, device=dev)
    rec["profile"] = dict(trace(lambda: sample2(g)), steps=PROFILED_STEPS)
    log_trace(f"{PROFILED_STEPS} unfused RK4 steps", rec["profile"])
    return rec


def train_unfused(cfg, model_u, gen_u, g, dev, step_auto):
    """Phase 16: the unfused route's training: agreement with the plain
    path, timed bare train steps, steps of both routes in turns and a
    traced step."""
    from sdeflow_tpu_torch.experiments.driver import (
        make_sampler, make_trainer)

    want = train_want("unfused")
    sampler = make_sampler(cfg, DIM, dev)
    x, draws = train_draws(gen_u, sampler, g, dev)
    rec = {"agreement": train_agreement(model_u, gen_u.ssm, g, x, draws,
                                        want)}
    trainer = make_trainer(cfg, gen_u, sampler, TRAIN_BATCH, log_fn=log)

    def step():
        xb = sampler.sample(g, TRAIN_BATCH)
        return trainer.train_step(trainer.state, g, xb)[1]

    step()  # warm
    rec.update(timed_train_steps(step, model_u, TIMED_STEPS_UNFUSED, want))
    rec["in_turns"] = in_turns({"auto": step_auto, "unfused": step},
                               REPLAY_STEPS)
    rec["profile"] = trace(step)
    log_trace("one unfused train step", rec["profile"])
    return rec


def check_long_attention(g, dev):
    """Phase 11: one unfused AttentionBlock at T = 4096: the forward under
    no_grad (the attention core K4), a jvp and a gradient with the block's
    parameters requiring grad (the pair K7a/K7b) against the plain path,
    with their launch counts, and a trace of three no-grad forwards."""
    from sdeflow_tpu_torch.models.unet2d import AttentionBlock
    from sdeflow_tpu_torch.ops.kernels import common

    b, c, h, w = LONG_BLOCK
    block = AttentionBlock(c, 1, "unfused").to(dev)
    randomize_(block, g)
    x = 2.0 * torch.randn(b, c, h, w, generator=g, device=dev) + 0.5
    v = torch.randn(x.shape, generator=g, device=dev)
    cot = torch.randn(x.shape, generator=g, device=dev)
    params = list(block.parameters())

    def run():
        with torch.no_grad():
            out = block(x)
        _, tan = torch.func.jvp(block, (x,), (v,))
        xg = x.detach().requires_grad_()
        grads = torch.autograd.grad((block(xg) * cot).sum(), [xg, *params])
        return out, tan, grads

    common.reset_launches()
    out, tan, grads = run()
    torch.cuda.synchronize()
    launched = launch_counts()
    want = {k: 0 for k in launched}
    # K5 in each of the three; K4 in the no-grad forward; K7a in the jvp
    # and in the gradient's forward; K7b and K5b in the gradient's backward
    want.update(group_norm_silu=3, qkv_attention_flash=1,
                qkv_attention_stats=2, qkv_attention_bwd=1,
                group_norm_silu_bwd=1)
    if launched != want:
        raise AssertionError(f"long attention launched {launched} != {want}")
    with plain_path():
        out_p, tan_p, grads_p = run()
    errs = {}
    for name, a, r, tol in [("output", out, out_p, 2e-5),
                            ("tangent", tan, tan_p, 2e-5),
                            *[(f"grad {i}", a, r, 1e-4) for i, (a, r)
                              in enumerate(zip(grads, grads_p))]]:
        errs[name] = (a - r).abs().max().item() / r.abs().max().item()
        if not errs[name] <= tol:
            raise AssertionError(f"long attention {name}: {errs[name]:.3g}")
    log(f"unfused AttentionBlock at (B, C, H, W) = {LONG_BLOCK}, T = {h * w}:"
        f" launches {launched}; max |Δ| / max |plain|: output "
        f"{errs['output']:.3g}, tangent {errs['tangent']:.3g} (tolerance "
        f"2e-5), gradients {max(v for k, v in errs.items() if 'grad' in k):.3g}"
        " (tolerance 1e-4)")
    with torch.no_grad():
        prof = trace(lambda: [block(x) for _ in range(3)])
    log_trace("three forwards of the T = 4096 block", prof)
    return {"launches": launched, "rel_err": errs, "profile": prof}


def lse_errs(ak, qkv, heads, lse, lse_p):
    """K7a's lse against the fp32 plain version (lse) and against the plain
    version run in float64 (lse64), and the fp32 plain's own distance from
    the latter (plain_lse64): max |Δ| each."""
    lse_d = ak.attention_flash_stats_math(qkv.double(), heads)[1]
    return {"lse": (lse - lse_p).abs().max().item(),
            "lse64": (lse.double() - lse_d).abs().max().item(),
            "plain_lse64": (lse_p.double() - lse_d).abs().max().item()}


def lse_sweep(ak, dev, strict=True):
    """K7a's lse on K7_LSE_DRAWS draws at K7_LSE_SHAPE, each held (when
    strict) to the plain version in float64 within K7_LSE_TOL and to the
    fp32 plain within K7_LSE_FP32_TOL; the worst of each reading of
    ``lse_errs`` over the draws."""
    b, t, c, heads = K7_LSE_SHAPE
    gs = torch.Generator(device=dev).manual_seed(K7_LSE_SEED)
    worst = {"lse": 0.0, "lse64": 0.0, "plain_lse64": 0.0}
    for _ in range(K7_LSE_DRAWS):
        qkv = 1.5 * torch.randn(b, t, 3 * c, generator=gs, device=dev)
        with torch.no_grad():
            lse = ak._launch_stats(qkv, heads)[1]
            lse_p = ak.attention_flash_stats_math(qkv, heads)[1]
            e = lse_errs(ak, qkv, heads, lse, lse_p)
        worst = {k: max(v, e[k]) for k, v in worst.items()}
    log(f"K7a lse over {K7_LSE_DRAWS} draws at {K7_LSE_SHAPE}: max |Δ| "
        f"against the plain in float64 {worst['lse64']:.3g} (tolerance "
        f"{K7_LSE_TOL:g}), against the fp32 plain {worst['lse']:.3g} "
        f"({K7_LSE_FP32_TOL:g}), the fp32 plain's own "
        f"{worst['plain_lse64']:.3g}")
    if strict and not (worst["lse64"] <= K7_LSE_TOL
                       and worst["lse"] <= K7_LSE_FP32_TOL):
        raise AssertionError(f"K7a's lse disagrees with plain: {worst}")
    return dict(worst, shape=list(K7_LSE_SHAPE), draws=K7_LSE_DRAWS,
                seed=K7_LSE_SEED)


def check_flash(g, dev):
    """Phase 17: K7a and K7b against their plain versions at K7_SHAPES, and
    their times at the first beside the bound and SDPA's forward and
    backward."""
    from sdeflow_tpu_torch.ops.kernels import attention as ak

    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs = {"out": 0.0, "lse": 0.0, "lse64": 0.0, "plain_lse64": 0.0,
            "dqkv": 0.0}
    rows = {}
    for b, t, c, heads in K7_SHAPES:
        qkv = 1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)
        dout = torch.randn(b, t, c, generator=g, device=dev)
        with torch.no_grad():
            out, lse = ak._launch_stats(qkv, heads)
            torch.cuda.synchronize()
            out_p, lse_p = ak.attention_flash_stats_math(qkv, heads)
            delta = (ak._heads(dout, heads) * ak._heads(out_p, heads)).sum(-1)
            dqkv = ak._launch_bwd(qkv, dout, lse_p, delta, heads)
            torch.cuda.synchronize()
            dqkv_p = ak.attention_flash_bwd_math(qkv, dout, lse_p, delta,
                                                 heads)
        e = {"out": ((out - out_p).abs().max() / out_p.abs().max()).item(),
             **lse_errs(ak, qkv, heads, lse, lse_p),
             "dqkv": ((dqkv - dqkv_p).abs().max()
                      / dqkv_p.abs().max()).item()}
        log(f"K7a/K7b ({b}, {t}, {c}) heads={heads}: max |Δ| / max |plain| "
            f"out {e['out']:.3g} (tolerance 2e-5), lse max |Δ| against the "
            f"plain in float64 {e['lse64']:.3g} ({K7_LSE_TOL:g}; against "
            f"the fp32 plain {e['lse']:.3g} ({K7_LSE_FP32_TOL:g}), the fp32 "
            f"plain's own {e['plain_lse64']:.3g}), dqkv {e['dqkv']:.3g} "
            "(1e-4)")
        if not (e["out"] <= 2e-5 and e["lse64"] <= K7_LSE_TOL
                and e["lse"] <= K7_LSE_FP32_TOL and e["dqkv"] <= 1e-4):
            raise AssertionError(f"K7a/K7b disagree with plain: {e}")
        errs = {k: max(v, e[k]) for k, v in errs.items()}
        if (b, t, c, heads) != K7_SHAPES[0]:
            continue
        # per call through the Function: its forward (no_grad), and its
        # backward alone (Δ, then K7b) on a retained graph
        x = qkv.detach().requires_grad_()
        y = ak.flash_attention_vjp(x, heads)
        q, k, v = (a.requires_grad_() for a in sdpa_args(qkv, heads))
        o = sdpa(q, k, v)
        do = ak._heads(dout, heads).contiguous()
        bound_7a = bound_ms(*k7a_cost(b, t, c, heads))
        bound_7b = bound_ms(*k7b_cost(b, t, c, heads))
        with torch.no_grad():
            rows["K7a"] = {
                "shape": [b, t, c], "heads": heads,
                "ms": cuda_ms(lambda: ak.flash_attention_vjp(qkv, heads)),
                "direct_ms": cuda_ms(lambda: ak._launch_stats(qkv, heads)),
                "plain_ms": cuda_ms(
                    lambda: ak.attention_flash_stats_math(qkv, heads)),
                "library_ms": cuda_ms(lambda: sdpa(q, k, v)),
                "bound_ms": bound_7a[0], "bound_by": bound_7a[1]}
            rows["K7b"] = {
                "shape": [b, t, c], "heads": heads,
                "direct_ms": cuda_ms(lambda: ak._launch_bwd(
                    qkv, dout, lse_p, delta, heads)),
                "plain_ms": cuda_ms(lambda: ak.attention_flash_bwd_math(
                    qkv, dout, lse_p, delta, heads), 10),
                "bound_ms": bound_7b[0], "bound_by": bound_7b[1]}
        rows["K7b"]["ms"] = cuda_ms(lambda: torch.autograd.grad(
            y, x, dout, retain_graph=True))
        rows["K7b"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True))
    rows["K7a"].update(max_abs_err=errs["out"], lse_max_abs_err=errs["lse"],
                       lse_max_abs_err_float64=errs["lse64"],
                       plain_lse_max_abs_err_float64=errs["plain_lse64"],
                       lse_draws=lse_sweep(ak, dev))
    rows["K7b"]["max_abs_err"] = errs["dqkv"]
    # at the DSM path's own shape: direct launches beside SDPA, few calls
    b, t, c = SGM_BATCH, 4096, 64
    qkv = 1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)
    dout = torch.randn(b, t, c, generator=g, device=dev)
    q, k, v = (a.requires_grad_() for a in sdpa_args(qkv, 1))
    o = sdpa(q, k, v)
    do = ak._heads(dout, 1).contiguous()
    with torch.no_grad():
        out, lse = ak._launch_stats(qkv, 1)
        delta = (ak._heads(dout, 1) * ak._heads(out, 1)).sum(-1)
        k7a_ms = cuda_ms(lambda: ak._launch_stats(qkv, 1), 5, 1)
        k7b_ms = cuda_ms(lambda: ak._launch_bwd(qkv, dout, lse, delta, 1),
                         3, 1)
        fwd_ms = cuda_ms(lambda: sdpa(q, k, v), 5, 1)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), do,
                                                 retain_graph=True), 3, 1)
    for name, ms, lib, cost in [("K7a", k7a_ms, fwd_ms, k7a_cost),
                                ("K7b", k7b_ms, bwd_ms, k7b_cost)]:
        bound, by = bound_ms(*cost(b, t, c, 1))
        rows[name]["dsm_shape"] = {"shape": [b, t, c], "heads": 1,
                                   "direct_ms": ms, "library_ms": lib,
                                   "bound_ms": bound, "bound_by": by}
        log(f"{name} at the DSM shape {[b, t, c]}: direct {ms:.3f} ms, SDPA "
            f"{lib:.3f} ms, bound {bound:.3f} ms ({by})")
    for name, r in rows.items():
        log(f"{name} at {r['shape']}: {r['ms']:.4f} ms per call (direct "
            f"{r['direct_ms']:.4f}), plain {r['plain_ms']:.4f}, SDPA "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return rows


def sgm_arm(g, dev):
    """The SGM arm of _grf(128) with random weights: its train config, the
    U-Net, the reverse SDE and the SmoothedGRF sampler."""
    from sdeflow_tpu_torch import build_sgm_arm
    from sdeflow_tpu_torch.configs import _grf
    from sdeflow_tpu_torch.experiments.driver import make_sampler

    cfg = _grf(SGM_NPIXEL)
    tc = cfg.train
    if (cfg.sweep.batch_sizes[0], tc.lr, tc.attention_impl) != (
            SGM_BATCH, 1e-4, "auto"):
        raise AssertionError("grf trains at batch 128, lr 1e-4, auto route")
    model, gen = build_sgm_arm(cfg, g, device=dev)
    randomize_(model, g)
    with torch.no_grad():  # a gentler score head, as for the MSGM arm
        model.core.conv_out.weight.mul_(0.1)
    return tc, model, gen, make_sampler(cfg, SGM_NPIXEL**2, dev)


def check_sgm_training(g, dev):
    """Phases 18 and 19: the SGM arm of _grf(128) (the grf U-Net at full
    width on 128×128 SmoothedGRF images, every AttentionBlock on the
    unfused route) trained by DSM: the kernel path against the plain path
    at batch 8, two Trainer steps, timed bare steps at batch 128 with their
    launch counts, the kernel and plain paths in turns at batch 8, and a
    traced step at batch 128."""
    from sdeflow_tpu_torch import Trainer
    from sdeflow_tpu_torch.models.unet2d import AttentionBlock
    from sdeflow_tpu_torch.ops.kernels import common

    tc, model, gen, sampler = sgm_arm(g, dev)
    dim = SGM_NPIXEL**2
    want = {k: SGM_WANT.get(k, 0) for k in common.KERNELS}
    seen = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.update([(inp[0].shape[1],
                                       math.prod(inp[0].shape[2:]))]))
        for m in model.modules() if isinstance(m, AttentionBlock)]
    with torch.no_grad():
        model(sampler.sample(g, 2), torch.rand(2, device=dev))
    for h in hooks:
        h.remove()
    if dict(seen) != SGM_BLOCKS:
        raise AssertionError(f"AttentionBlocks at (C, T): {dict(seen)}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"SGM arm of grf{SGM_NPIXEL}: AttentionBlocks (C, T) {dict(seen)}, "
        f"all on the unfused route; {n_params} parameters")
    # K5 and K5b at the step's own GroupNorm mix, beside PyTorch's GroupNorm
    # forward and backward and the bound
    mix = gn_mix(model, dev, sampler.sample(g, 2))
    if dict(mix) != SGM_GN_MIX:
        raise AssertionError(f"DSM GroupNorms per forward: {dict(mix)}")
    k5_dsm = k5_rows(g, dev, mix, SGM_BATCH, iters=5)
    log_k5_rows("K5", k5_dsm)
    k5b_dsm = k5b_rows(g, dev, mix, SGM_BATCH, iters=5)
    log_k5_rows("K5b", k5b_dsm)

    # (a) the kernel path against the plain path on one batch of 8
    b = SGM_AGREE_BATCH
    x = sampler.sample(g, b)
    draws = dict(t=gen.sample_t(g, b),
                 noise=torch.randn(b, dim, generator=g, device=dev))
    rec = {"agreement": train_agreement(model, gen.dsm, g, x, draws, want),
           "k5_dsm": k5_dsm, "k5b_dsm": k5b_dsm}

    # (b) the Trainer: two DSM steps with ELBO prints (SSM under no_grad)
    t0 = time.perf_counter()
    trainer = Trainer(gen, sampler, lr=tc.lr, batch_size=SGM_BATCH,
                      loss="dsm", log_fn=log)
    state, loss = trainer.run(g, 2, x_test=sampler.sample(g, SGM_BATCH))
    torch.cuda.synchronize()
    rec["trainer_s"] = time.perf_counter() - t0
    if not (state.step == 2 and math.isfinite(loss)
            and all(math.isfinite(h["elbo"]) for h in trainer.history)):
        raise AssertionError(f"SGM Trainer: step {state.step}, {loss}, "
                             f"{trainer.history}")

    def step(batch=SGM_BATCH):
        return trainer.train_step(trainer.state, g,
                                  sampler.sample(g, batch))[1]

    # (c) timed bare steps at grf's batch
    rec.update(timed_train_steps(step, model, SGM_TIMED_STEPS, want,
                                 SGM_BATCH))

    # (d) the kernel and the plain path in turns at batch 8
    turns = []
    for mode in ("plain", "kernel", "kernel", "plain"):
        with plain_path() if mode == "plain" else contextlib.nullcontext():
            common.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(SGM_AGREE_BATCH)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        if launch_counts() != (want if mode == "kernel" else
                               {k: 0 for k in want}):
            raise AssertionError(f"{mode} DSM step launched "
                                 f"{launch_counts()}")
        turns.append({"mode": mode, "ms": ms})
        log(f"{mode} DSM step at batch {SGM_AGREE_BATCH}: {ms:.1f} ms")
    rec["turns"] = turns

    # 19. where one DSM step's time goes at batch 128
    rec["profile"] = trace(step)
    log_trace(f"one DSM step at batch {SGM_BATCH}", rec["profile"])
    return rec


def gn_timing(g, dev, record):
    """--only gn: K5 and its backward timed at grf16's GroupNorm mix
    (B = 1024) and at the DSM step's (B = 128), in fp32 and, at the DSM
    step's, in bf16 beside ``F.group_norm`` in bf16 and its backward (the
    bound from k5_cost / k5b_cost at 2 bytes an element); K5 bf16 also at
    grf16's mix (B = 1024) and the SSM step's (B = 128), with its device
    time alone at all three bf16 mixes, each mix's means per launch
    printed; and one traced fp32 DSM step at batch 128 with the device
    time under GroupNormSiLUBackward."""
    from sdeflow_tpu_torch import Trainer, build_msgm_arm, get_preset

    model, _ = build_msgm_arm(get_preset("grf16"), g, device=dev)
    mix = gn_mix(model, dev)
    bf = torch.bfloat16
    for name, mx, b, iters, dt in [
            ("grf16", mix, N_SAMPLES, 20, torch.float32),
            ("dsm", SGM_GN_MIX, SGM_BATCH, 5, torch.float32),
            ("dsm_bf16", SGM_GN_MIX, SGM_BATCH, 5, bf)]:
        record[f"k5_{name}"] = k5_rows(g, dev, mx, b, iters, dt,
                                       device=dt == bf)
        log_k5_rows(f"K5 ({name})", record[f"k5_{name}"])
        record[f"k5b_{name}"] = k5b_rows(g, dev, mx, b, iters, dt)
        log_k5_rows(f"K5b ({name})", record[f"k5b_{name}"])
    for name, b in (("grf16_bf16", N_SAMPLES), ("ssm_bf16", TRAIN_BATCH)):
        record[f"k5_{name}"] = k5_rows(g, dev, mix, b, 20, bf, device=True)
        log_k5_rows(f"K5 ({name})", record[f"k5_{name}"])
    for key in ("k5_dsm_bf16", "k5_grf16_bf16", "k5_ssm_bf16",
                "k5b_dsm_bf16"):
        rows = record[key]
        mean = {k: weighted(rows, k) for k in (
            "ms", "direct_ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms") if k in rows[0]}
        record[key + "_mix"] = mean
        log(f"{key} over its mix, per launch: " + ", ".join(
            f"{k} {v:.4f}" for k, v in mean.items()))
    tc, model, gen, sampler = sgm_arm(g, dev)
    trainer = Trainer(gen, sampler, lr=tc.lr, batch_size=SGM_BATCH,
                      loss="dsm")
    record["dsm_profile"] = trace(lambda: trainer.train_step(
        trainer.state, g, sampler.sample(g, SGM_BATCH)))
    log_trace(f"one DSM step at batch {SGM_BATCH}", record["dsm_profile"])


# phase 20: the experiment driver through its CLI on grf16 at full width,
# both arms trained by SSM at grf16's batch, sampled and scored
DRIVER_ITERATIONS = 8
DRIVER_ARGS = ["--preset", "grf16", "--iterations", str(DRIVER_ITERATIONS),
               "--num-samples", str(N_SAMPLES), "--steps-backward",
               str(STEPS), "--eval-mmd", "--no-plots"]
DRIVER_SCORED = N_SAMPLES - 1  # the metric block scores n - 1 rows
# the kernels of the driver's path: each must launch in its run
DRIVER_KERNELS = ("circulant_apply", "circulant_rk4_solve",
                  "fused_attention_block", "group_norm_silu",
                  "group_norm_silu_bwd")


def sgm_ssm_want(route="auto"):
    """Launches per bare SSM step of the SGM arm: the closed-form forward
    kernel (no K1, no K2), then the MSGM step's U-Net launches."""
    want = train_want(route)
    return dict(want, circulant_apply=0, circulant_rk4_step=0,
                circulant_rk4_solve=0)


def gen_want(is_msgm):
    """Launches per generation run of an arm: the serve path's, without
    K1 on the SGM arm (its diffusion is a scalar)."""
    want = serve_want("auto")
    return want if is_msgm else dict(want, circulant_apply=0)


def timed_call(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its kernel launches, wall time
    (synchronized; and between CUDA events on the stream, ``event_ms``)
    and peak memory, and the states of its generator arguments before the
    call; returns the record, the result under "out"."""
    before = launch_counts()
    states = [a.get_state() for a in args if isinstance(a, torch.Generator)]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    events[0].record()
    out = fn(*args, **kwargs)
    events[1].record()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = launch_counts()
    return dict(args=args, kwargs=kwargs, out=out, ms=ms,
                event_ms=events[0].elapsed_time(events[1]),
                peak=torch.cuda.max_memory_allocated(),
                generator_states=states,
                launches={k: after[k] - before[k] for k in after})


def spied(module, name, calls):
    """Wrap module.<name> so that each call appends its timed_call record
    to `calls`."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(timed_call(orig, *args, **kwargs))
        return calls[-1]["out"]

    return swapped([(module, name, wrapper)])


def counted_steps(steps):
    """Wrap every train step the Trainers build: each bare step appends
    its timed_call record with its arm (the base SDE's name), its loss,
    the state and, on an arm's first step, its parameters before it (the
    ELBO prints run outside the step)."""
    from sdeflow_tpu_torch.training import train as train_mod

    make = train_mod.make_train_step

    def make_counted(optimizer, *a, **k):
        step = make(optimizer, *a, **k)

        def counted(state, *args, **kwargs):
            arm = state.gen_sde.base_sde.name
            before = (None if any(r["arm"] == arm for r in steps) else
                      [p.detach().clone() for p in state.params.values()])
            rec = timed_call(step, state, *args, **kwargs)
            rec.update(arm=arm, loss=rec["out"][1], state=state,
                       params_before=before, optimizer=optimizer)
            steps.append(rec)
            return rec["out"]

        return counted

    return swapped([(train_mod, "make_train_step", make_counted)])


def mmd64(x, y):
    """MMD² of the centered Gaussian kernel in float64 on the CPU."""
    x, y = x.double().cpu(), y.double().cpu()
    d = x.shape[1]

    def km(a, b):
        sq = torch.clamp((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
                         - 2.0 * a @ b.T, min=0.0)
        return torch.expm1(-sq / d**2).mean().item()

    return km(x, x) + km(y, y) - 2.0 * km(x, y)


def replay_errs(xs, xp, filter_blowups):
    """A generation run's trajectory xs (S, N, d) against its plain replay
    xp, on the rows whose last plain state filter_blowups keeps: at each
    state the max |xs − xp| over those rows over the rms of xp there; the
    worst state's ratio, error and rms, with the error and the largest
    |x| over every row and state."""
    last = xp[-1]
    kept = torch.isfinite(last).all(1) & (last.abs() <= 1e3).all(1)
    n_kept = int(kept.sum())
    if n_kept != last.shape[0] - filter_blowups(last)[1] or not n_kept:
        raise AssertionError(f"replay: {n_kept} rows kept")
    diff = xs[:, kept] - xp[:, kept]
    err = diff.abs().amax(dim=(1, 2))
    rms = xp[:, kept].square().mean(dim=(1, 2)).sqrt()
    rel = err / rms
    rms_rel = diff.square().mean(dim=(1, 2)).sqrt() / rms
    s = int(rel.argmax())
    return dict(rel=rel[s].item(), state=s, max_abs_err=err[s].item(),
                rms=rms[s].item(), rows_kept=n_kept,
                rel_per_state=rel.tolist(),
                rms_rel=rms_rel.max().item(),
                max_abs_err_all=(xs - xp).abs().max().item(),
                max_abs_x=xp.abs().max().item())


def check_driver(g, dev, card):
    """Phase 20: the experiment driver's CLI (``sdeflow_tpu_torch.run``)
    on grf16 at full width, both arms trained by SSM, sampled and scored,
    in a temporary cwd and results directory, with its checks."""
    import tempfile

    import numpy as np

    from sdeflow_tpu_torch import build_sgm_arm, get_preset
    from sdeflow_tpu_torch import run as run_mod
    from sdeflow_tpu_torch.eval import compute_mmd, sliced_wasserstein
    from sdeflow_tpu_torch.eval.diagnostics import filter_blowups
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.experiments.naming import (
        run_name_root, simulation_name)
    from sdeflow_tpu_torch.ops.hutchinson import sample_v
    from sdeflow_tpu_torch.ops.kernels import common

    cfg = get_preset("grf16")
    tc, sw = cfg.train, cfg.sweep
    if (sw.batch_sizes[0], sw.fair_comparison, sw.msgms) != (
            TRAIN_BATCH, False, (0, 1)):
        raise AssertionError("grf16: both arms at batch 128, no fair budget")
    rec = {"card": card, "args": DRIVER_ARGS}

    # (a) the SGM arm's SSM loss and gradients, kernel path against plain
    model, gen = build_sgm_arm(cfg, None, device=dev)
    randomize_(model, g)
    with torch.no_grad():  # a gentler score head, as for the MSGM arm
        model.core.conv_out.weight.mul_(0.1)
    x = drv.make_sampler(cfg, DIM, device=dev).sample(g, TRAIN_BATCH)
    draws = dict(t=gen.sample_t(g, TRAIN_BATCH),
                 noise=torch.randn(TRAIN_BATCH, DIM, generator=g, device=dev),
                 v=sample_v(g, (TRAIN_BATCH, DIM), gen.vtype, device=dev))
    rec["sgm_ssm_agreement"] = train_agreement(model, gen.ssm, g, x, draws,
                                               sgm_ssm_want())
    # where one SGM SSM step's time goes (the driver's own Trainer build)
    sampler = drv.make_sampler(cfg, DIM, device=dev)
    trainer = drv.make_trainer(cfg, gen, sampler, TRAIN_BATCH, log_fn=log)
    rec["sgm_ssm_profile"] = trace(lambda: trainer.train_step(
        trainer.state, g, sampler.sample(g, TRAIN_BATCH)))
    log_trace(f"one SGM SSM train step at batch {TRAIN_BATCH}",
              rec["sgm_ssm_profile"])
    del model, gen, trainer

    # (b) the driver's run, its kernels' launches counted from 0
    steps, gens, scores = [], [], []
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        results_dir = os.path.join(tmp, "results")
        args = [*DRIVER_ARGS, "--results-dir", results_dir]
        os.chdir(tmp)
        try:
            with counted_steps(steps), spied(drv, "generate", gens), \
                    spied(drv, "postprocessing", scores):
                common.reset_launches()
                t0 = time.perf_counter()
                results = run_mod.main(args)
                torch.cuda.synchronize()
                rec["driver_s"] = time.perf_counter() - t0
                rec["launches"] = launch_counts()
            reloaded = run_mod.main([*args, "--just-load-mmd"])
            files = sorted(os.path.relpath(os.path.join(d, f), results_dir)
                           for d, _, fs in os.walk(results_dir) for f in fs)
        finally:
            os.chdir(cwd)
    log(f"driver: {rec['driver_s']:.1f} s, launches {rec['launches']}")
    missing = [k for k in DRIVER_KERNELS if not rec["launches"][k]]
    if missing:
        raise AssertionError(f"the driver's run never launched {missing}")

    # (c) training: both arms, their bare steps and launches
    arms = {"SGM": "SGM", "MSGM": "MSGM_sparseTenslogNorm"}
    rec["train"] = {}
    for arm, sde_name in arms.items():
        mine = [r for r in steps if r["arm"] == sde_name]
        want = train_want("auto") if arm == "MSGM" else sgm_ssm_want()
        if len(mine) != DRIVER_ITERATIONS:
            raise AssertionError(f"{arm}: {len(mine)} train steps")
        bad = [r["launches"] for r in mine if r["launches"] != want]
        if bad:
            raise AssertionError(f"{arm} step launches {bad[0]} != {want}")
        losses = torch.stack([r["loss"] for r in mine])
        state = mine[-1]["state"]
        moved = max((p.detach() - q).abs().max().item() for p, q in zip(
            state.params.values(), mine[0]["params_before"]))
        if not (torch.isfinite(losses).all() and moved > 0):
            raise AssertionError(f"{arm}: losses {losses}, moved {moved}")
        ms = [r["ms"] for r in mine]
        rec["train"][arm] = dict(
            ms_per_step=ms, ms_per_step_after_first=sum(ms[1:]) / len(ms[1:]),
            max_memory_allocated=max(r["peak"] for r in mine),
            launches_per_step=mine[-1]["launches"],
            losses=losses.tolist(), param_moved=moved)
        log(f"{card}: {arm} bare SSM steps at batch {TRAIN_BATCH}: "
            f"{rec['train'][arm]['ms_per_step_after_first']:.1f} ms/step "
            f"(steps 2-{DRIVER_ITERATIONS}; the first {ms[0]:.1f} ms), peak "
            f"{rec['train'][arm]['max_memory_allocated'] / 2**20:.1f} MiB, "
            f"launches {mine[-1]['launches']}")

    # (d) generation: one run per arm, its launches, norms and replay
    if len(gens) != 2:
        raise AssertionError(f"{len(gens)} generation runs, expected 2")
    rec["generate"] = {}
    for (arm, is_msgm), r in zip((("SGM", False), ("MSGM", True)), gens):
        xs = r["out"]
        if tuple(xs.shape) != (STEPS + 1, N_SAMPLES, DIM) or \
                not torch.isfinite(xs).all():
            raise AssertionError(f"{arm}: trajectory {tuple(xs.shape)}")
        if r["launches"] != gen_want(is_msgm):
            raise AssertionError(f"{arm} generation launches "
                                 f"{r['launches']} != {gen_want(is_msgm)}")
        norms = xs.norm(dim=2)
        kept = bool(torch.allclose(norms, norms[0].expand_as(norms),
                                   rtol=1e-5, atol=0))
        if kept is not is_msgm:
            raise AssertionError(f"{arm}: norms kept = {kept}")
        rec["generate"][arm] = dict(ms=r["ms"], launches=r["launches"],
                                    peak=r["peak"], norms_kept=kept)
        log(f"{card}: {arm} generation of {N_SAMPLES} samples x {STEPS} "
            f"RK4 steps (trajectory kept): {r['ms']:.1f} ms, launches "
            f"{r['launches']}, norms kept {kept}")
    # the SGM arm's run replayed on the plain path: same x0 and noise
    r = gens[0]
    replay_g = torch.Generator(device=dev)
    replay_g.set_state(r["generator_states"][0])
    args = list(r["args"])
    args[1] = replay_g
    common.reset_launches()
    with plain_path():
        xp = drv.generate(*args, **r["kwargs"])
    if any(launch_counts().values()):
        raise AssertionError(f"plain replay launched {launch_counts()}")
    replay = replay_errs(r["out"], xp, filter_blowups)
    rec["generate"]["SGM"]["plain_replay"] = replay
    log(f"SGM generation replayed plain on the {replay['rows_kept']} rows "
        f"that filter_blowups keeps: max over states of max |kernel - "
        f"plain| / rms(plain) = {replay['rel']:.3g} (tolerance 1e-3), at "
        f"state {replay['state']}: max |Δ| {replay['max_abs_err']:.3g}, rms "
        f"{replay['rms']:.3g}; over every row and state max |Δ| "
        f"{replay['max_abs_err_all']:.3g}, max |x| {replay['max_abs_x']:.3g}")
    if not replay["rel"] <= 1e-3:
        raise AssertionError("SGM generation: kernel and plain disagree")

    # (e) the metrics
    for k in drv.METRICS:
        if results[k].shape != (1, 1, 1, 1, 1) or \
                not np.isfinite(results[k]).all():
            raise AssertionError(f"results[{k!r}] = {results[k]}")
        if not np.array_equal(reloaded[k], results[k]):
            raise AssertionError(f"--just-load-mmd reloaded {k} differently")
    sgm_out, msgm_out = (c["out"] for c in scores)
    for k in ("mmd_ref", "swd_ref"):
        if sgm_out[k] != msgm_out[k]:
            raise AssertionError(f"{k} differs between the arms: "
                                 f"{sgm_out[k]} != {msgm_out[k]}")
    rec["results"] = {k: results[k].ravel().tolist() for k in drv.METRICS}
    rec["metrics"] = {}
    for arm, c in zip(("SGM", "MSGM"), scores):
        xs, xtest = c["args"][1], c["args"][2]
        xg = torch.as_tensor(filter_blowups(xs[-1])[0][:DRIVER_SCORED],
                             device=dev)
        xt = xtest[:DRIVER_SCORED]
        ref = mmd64(xg, xt)
        rel = abs(c["out"]["mmd"] - ref) / ref
        m = dict(mmd=c["out"]["mmd"], mmd_float64=ref, rel=rel,
                 sqrt_mmd=c["out"]["mmd"] ** 0.5, swd=c["out"]["swd"],
                 nan_count=c["out"]["nan_count"])
        if arm == "MSGM":  # the metrics' own times, at the scored shape
            m["mmd_ms"] = cuda_ms(lambda: compute_mmd(xg, xt), iters=10,
                                  warmup=2)
            gs = torch.Generator(device=dev).manual_seed(0)
            m["swd_ms"] = cuda_ms(lambda: sliced_wasserstein(gs, xg, xt),
                                  iters=10, warmup=2)
            log(f"{card}: one MMD at {tuple(xg.shape)}: {m['mmd_ms']:.3f} "
                f"ms, one SWD: {m['swd_ms']:.3f} ms")
        rec["metrics"][arm] = m
        log(f"{arm}: sqrt-MMD {m['sqrt_mmd']:.5f}, MMD^2 {m['mmd']:.6g} "
            f"against float64 {ref:.6g} (rel {rel:.3g}, tolerance 1e-3), "
            f"SWD {m['swd']:.5f}")
        if not rel <= 1e-3:
            raise AssertionError(f"{arm}: MMD^2 on the card disagrees with "
                                 "float64")
    rec["mmd_ref"] = sgm_out["mmd_ref"]

    # (f) the files, under the JAX package's names
    want_files = [f"global{m}file_{a}_1runs.npy" for m in ("MMD", "SWD")
                  for a in ("SGM", "MSGM", "ref")]
    for arm, sde_name in arms.items():
        is_msgm = arm == "MSGM"
        root = run_name_root(
            "grf16", sde_name, DRIVER_ITERATIONS,
            min(tc.num_samples_init_max, DRIVER_ITERATIONS * TRAIN_BATCH),
            TRAIN_BATCH, tc.num_steps_forward, tc.beta_min, tc.beta_max,
            tc.beta_min_sgm, tc.beta_max_sgm, is_msgm, nn_archi=tc.nn_archi,
            premodule="NormalizeLogRadius" if is_msgm else None, lr=tc.lr,
            vtype=tc.vtype, fair_comparison=sw.fair_comparison)
        name = os.path.relpath(simulation_name(
            results_dir, root, tc.t_eps, STEPS, sw.include_t0_reverse),
            results_dir)
        want_files += [name + ".npy", name + "_traj.npy",
                       root + "_checkpoint_final"]
    absent = sorted(set(want_files) - set(files))
    rec["files"] = files
    if absent:
        raise AssertionError(f"files absent: {absent}; present: {files}")
    log(f"driver files: {len(files)}, all {len(want_files)} expected present")
    return rec


# phase 21: the bf16 variants of K5, K5b and K3 against their plain twins
K3_BF16_SHAPES = [(1024, 64, 64), (1024, 16, 128)]  # (B, T, C), one head
# K3 bf16 is also held at the SSM step's batch, with four heads (head width
# 16: chunk 16, V stored transposed), and at the T = 256, 8-head blocks of
# groups 32 that fp32 holds with qkv in scratch: (B, T, C, heads, groups)
K3_BF16_MORE = [(16, 64, 64, 4, 32), (4, 256, 32, 8, 32), (4, 256, 64, 8, 32)]
# K5: two bf16 ulps of the largest output; K5b: dx against the fp32
# evaluation of the vjp of the bf16 forward (the kernel rounds dx once, the
# plain fp32 vjp not at all), dγ and dβ (fp32 sums over the batch) against
# float64; K3: the JAX package holds its own bf16 kernel to atol 4e-2
# (tests/test_pallas_kernels.py:335-392)
K5_BF16_TOL, K5B_BF16_TOL, K5B_PARAM_TOL = 1.6e-2, 2e-2, 1e-3
K3_BF16_TOL = 2e-2


def bits_equal(a, b):
    """a and b equal bit for bit (bf16 or fp32)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def rel_err(a, ref):
    """max |a − ref| / max |ref|, in the precision of ref."""
    return ((a.to(ref.dtype) - ref).abs().max() / ref.abs().max()).item()


def check_k5_k5b_bf16(g, dev, b, c, s, silu, errs):
    """bf16 K5 and K5b at one (B, C, S, silu) against their plain twins
    (K5 within K5_BF16_TOL and no farther from the fp32 plain version than
    1.5× the twin plus 1e-3·max, dx within K5B_BF16_TOL, dγ/dβ against
    float64 within K5B_PARAM_TOL), both equal bit for bit on a second run;
    the worst errors go into errs."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk

    bf = torch.bfloat16
    x, gamma, beta, groups = gn_args(g, dev, b, c, s, group_count(c), bf)
    dy = torch.randn(x.shape, generator=g, device=dev).to(bf)
    out = gnk._launch(x, gamma, beta, groups, silu)
    out2 = gnk._launch(x, gamma, beta, groups, silu)
    dx, dgam, dbet = gnk._launch_vjp(x, gamma, beta, groups, silu, dy)
    again = gnk._launch_vjp(x, gamma, beta, groups, silu, dy)
    torch.cuda.synchronize()
    if not all(bits_equal(u, v) for u, v in zip((out, dx, dgam, dbet),
                                                (out2, *again))):
        raise AssertionError(f"bf16 K5/K5b at {(b, c, s)} silu={silu}: a "
                             "second run differs")
    twin = gnk.gn_math(x, gamma, beta, groups, silu).float()
    e5 = rel_err(out, twin)
    fp32 = gnk.gn_math(x.float(), gamma, beta, groups, silu)
    mine = (out.float() - fp32).abs().max().item()
    theirs = (twin - fp32).abs().max().item()
    if mine > 1.5 * theirs + 1e-3 * fp32.abs().max().item():
        raise AssertionError(
            f"bf16 K5 at {(b, c, s)} silu={silu}: {mine:.3g} from fp32, the "
            f"twin {theirs:.3g}")
    del out, out2, again, twin, fp32
    dx_ref = gnk.gn_math_vjp(x.float(), gamma, beta, groups, silu,
                             dy.float())[0]
    e_dx = rel_err(dx, dx_ref)
    del dx_ref
    _, dg64, db64 = gnk.gn_math_vjp(x.double(), gamma.double(),
                                    beta.double(), groups, silu, dy.double())
    e_p = max(rel_err(dgam, dg64), rel_err(dbet, db64))
    if not (e5 <= K5_BF16_TOL and e_dx <= K5B_BF16_TOL
            and e_p <= K5B_PARAM_TOL):
        raise AssertionError(
            f"bf16 K5/K5b at {(b, c, s)} silu={silu}: K5 {e5:.3g}, dx "
            f"{e_dx:.3g}, dγ/dβ {e_p:.3g}")
    errs["k5"] = max(errs["k5"], e5)
    errs["k5b_dx"] = max(errs["k5b_dx"], e_dx)
    errs["k5b_params"] = max(errs["k5b_params"], e_p)


def log_k5_k5b_bf16(what, checks, errs):
    log(f"bf16 K5/K5b at {checks} (B, C, S, silu) of {what}: max |kernel - "
        f"plain| / max |plain| K5 {errs['k5']:.3g} (tolerance "
        f"{K5_BF16_TOL:g}), K5b dx {errs['k5b_dx']:.3g} ({K5B_BF16_TOL:g}), "
        f"dγ/dβ against float64 {errs['k5b_params']:.3g} "
        f"({K5B_PARAM_TOL:g}); K5 no farther from fp32 than 1.5× the twin; "
        "K5 and K5b equal bit for bit on a second run")


def check_bf16_kernels(g, dev, mix):
    """Phase 21: K5, K5b and K3 in bf16 against their plain twins: K5 and
    K5b at every (C, S) of a grf16 forward's GroupNorm mix at B = 1024 and
    B = 128, SiLU on and off, and at every (C, S, silu) of the bf16 DSM
    step's mix (SGM_GN_MIX) at its batch, where K5b bf16 takes its cluster
    kernel at clusters of 1, 2, 4 and 8 blocks and K5 bf16 its own at 1, 2
    and 4; K3 as check_k3_bf16 holds
    it; their times at grf16's mixes beside the plain versions, PyTorch's
    GroupNorm forward and backward in bf16 and the bounds."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk

    bf = torch.bfloat16
    errs = {"k5": 0.0, "k5b_dx": 0.0, "k5b_params": 0.0, "k3": 0.0}
    checks = 0
    with torch.no_grad():
        for b in (N_SAMPLES, TRAIN_BATCH):
            for c, s in sorted({(c, s) for c, s, _ in mix}):
                for silu in (False, True):
                    check_k5_k5b_bf16(g, dev, b, c, s, silu, errs)
                    checks += 1
    log_k5_k5b_bf16("grf16's mix", checks, errs)
    plans = {(c, s): gnk.bwd_bf16_plan(c // group_count(c) * s, s)
             for c, s, _ in SGM_GN_MIX}
    clusters = {p.cluster for p in plans.values() if p.kind == "cluster"}
    if clusters != {1, 2, 4, 8} or any(p.kind == "small"
                                       for p in plans.values()):
        raise AssertionError(f"bf16 K5b plans at the DSM mix: {plans}")
    # K5 bf16: one block up to 16,384 elements, clusters of 2 and 4 above
    fwd_plans = {(c, s): gnk.fwd_bf16_plan(c // group_count(c) * s, s)
                 for c, s, _ in SGM_GN_MIX}
    fwd_clusters = {p.cluster for p in fwd_plans.values()}
    if fwd_clusters != {1, 2, 4} or any(p.kind != "cluster"
                                        for p in fwd_plans.values()):
        raise AssertionError(f"bf16 K5 plans at the DSM mix: {fwd_plans}")
    dsm_errs = {"k5": 0.0, "k5b_dx": 0.0, "k5b_params": 0.0}
    with torch.no_grad():
        for c, s, silu in sorted(SGM_GN_MIX):
            check_k5_k5b_bf16(g, dev, SGM_BATCH, c, s, silu, dsm_errs)
            torch.cuda.empty_cache()
    log_k5_k5b_bf16(f"the bf16 DSM step's mix at B = {SGM_BATCH} (K5 "
                    f"clusters {sorted(fwd_clusters)}, K5b clusters "
                    f"{sorted(clusters)})", len(SGM_GN_MIX), dsm_errs)
    errs.update({f"dsm_{k}": v for k, v in dsm_errs.items()})
    k3 = check_k3_bf16(g, dev, errs)
    rows = {"k3": [r for r in k3 if r["shape"][0] == N_SAMPLES],
            "k3_ssm": [r for r in k3 if r["shape"][0] == TRAIN_BATCH]}
    for name, b, iters in (("grf16", N_SAMPLES, 20), ("ssm", TRAIN_BATCH, 20)):
        rows[f"k5_{name}"] = k5_rows(g, dev, mix, b, iters, bf)
        log_k5_rows(f"bf16 K5 ({name} mix)", rows[f"k5_{name}"])
        rows[f"k5b_{name}"] = k5b_rows(g, dev, mix, b, iters, bf)
        log_k5_rows(f"bf16 K5b ({name} mix)", rows[f"k5b_{name}"])
    for r in k3:
        log(f"bf16 K3 at {r['shape']}: {r['ms']:.4f} ms per call (direct "
            f"{r['direct_ms']:.4f}), plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return dict(rows, max_errs=errs, gn_checks=checks + len(SGM_GN_MIX))


def check_k3_bf16(g, dev, errs):
    """K3 bf16 (``_launch``, one kernel a call) against its plain twin at
    K3_BF16_SHAPES at B = 1024 and 128, and at K3_BF16_MORE, with random
    non-zero weights: phase 23's two gates (within K3_BF16_TOL·max of the
    plain bf16 twin; no farther from the fp32 plain on the widened inputs
    than 1.5× the twin plus 1e-3·max), equal bit for bit on a second run,
    and exactly one device kernel per direct call in a trace. Returns the
    timed rows (one head, both batches): per call through the Function,
    direct, plain, bound."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import attnblock as ab

    bf = torch.bfloat16
    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    shapes = [(b, t, c, 1, group_count(c)) for b in (N_SAMPLES, TRAIN_BATCH)
              for t, c in [s[1:] for s in K3_BF16_SHAPES]] + K3_BF16_MORE
    rows = []
    with torch.no_grad():
        for b, t, c, heads, groups in shapes:
            args = block_args(g, dev, b, t, c)
            args[0] = args[0].to(bf)
            if ab.block_plan(t, c, groups, heads, bf) is None:
                raise AssertionError(f"K3 bf16 has no plan at {(t, c)}")
            out = ab._launch(*args, groups, heads)
            again = ab._launch(*args, groups, heads)
            torch.cuda.synchronize()
            log(f"bf16 K3 ({b}, {t}, {c}) heads={heads} groups={groups}, "
                f"plan {tuple(ab.block_plan(t, c, groups, heads, bf))}:")
            err, mine, theirs = bf16_gates(
                "K3", out, ab.attn_block_math(*args, groups, heads),
                ab.attn_block_math(args[0].float(), *args[1:], groups,
                                   heads), K3_BF16_TOL)
            errs["k3"] = max(errs["k3"], err)
            if not torch.equal(out.view(torch.int16), again.view(torch.int16)):
                raise AssertionError(f"bf16 K3 at {(b, t, c)} differs from "
                                     "run to run")
            kernels = kernels_per_call(
                lambda: ab._launch(*args, groups, heads))
            per_call = sum(kernels.values())
            log(f"  bit for bit on a second run; {per_call:g} device "
                f"kernel(s) per direct call: {sorted(kernels)}")
            if per_call != 1 or not all("attn_block_bf16_kernel" in k
                                        for k in kernels):
                raise AssertionError(f"a direct K3 bf16 call ran {kernels}")
            if heads == 1:
                bound, by = bound_bf16_ms(*k3_bf16_cost(b, t, c, 1))
                rows.append({
                    "shape": [b, t, c], "heads": 1, "max_abs_err": err,
                    "from_fp32": mine, "plain_from_fp32": theirs,
                    "calls_per_forward": BLOCK_MIX[(t, c)],
                    "ms": cuda_ms(lambda: ab.fused_attention_block(
                        *args, groups, 1)),
                    "direct_ms": cuda_ms(lambda: ab._launch(*args, groups,
                                                            1)),
                    "plain_ms": cuda_ms(lambda: ab.attn_block_math(
                        *args, groups, 1)),
                    "bound_ms": bound, "bound_by": by})
            del args, out, again
    mm.allow_bf16_reduced_precision_reduction = reduced
    return rows


# phase 22: the grf16_production preset through the CLI: both arms trained
# by SSM in bf16 compute, sampled by EM-32 plus one Langevin corrector
# step, scored
PROD_ARGS = ["--preset", "grf16_production", "--iterations",
             str(DRIVER_ITERATIONS), "--num-samples", str(N_SAMPLES),
             "--eval-mmd", "--no-plots"]
PROD_STEPS, PROD_CORRECTOR = 32, 1
# net evaluations per predictor-corrector step: the EM predictor's drift
# and the corrector's
PROD_EVALS_PER_STEP = 1 + PROD_CORRECTOR
# the bf16 SSM loss with kernels against plain: bf16's 2^-8 rounded at
# other places by the kernels than by the plain versions
PROD_LOSS_TOL, PROD_GRAD_TOL = 1e-2, 3e-2
# the replayed request: each state within 2e-2 of its rms (max |Δ| over
# the state), or the kernel run no farther from the same request computed
# in fp32 than 1.5× the plain bf16 run is, both in rms |Δ| and (plus 2e-2)
# in max |Δ|, relative to each state's rms: the kernels round at other
# places than the plain versions (K3 adds the qkv and output biases to
# fp32 sums before rounding, the plain version rounds the product, then
# the sum), and 64 net evaluations of the reverse SDE amplify a rounding
# apart as they amplify bf16's own (the plain bf16 run lay 0.0245-0.0995
# of the rms from the fp32 run in max |Δ| on the same draws)
PROD_REPLAY_TOL = 2e-2


def prod_gen_want(route="auto"):
    """The U-Net's launches per production request on an AttentionBlock
    route (its per forward times the net evaluations; on "auto" K3 and K5,
    on "unfused" K5 and K6, the other attention kernels and K5b none); K1
    is counted, not held (4 per PC step predicted: the predictor's drift
    and noise, the corrector's drift and noise)."""
    evals = PROD_EVALS_PER_STEP * PROD_STEPS
    return {k: n * evals for k, n in per_forward(route).items()}


def check_production(g, dev, card):
    """Phase 22: the bf16 SSM loss of the SGM arm with kernels against
    plain; traces of one bf16 SSM step and one 2-step PC request; then
    ``sdeflow_tpu_torch.run.main`` on grf16_production with its checks."""
    from sdeflow_tpu_torch import build_sgm_arm, get_preset
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops.hutchinson import sample_v

    cfg = get_preset("grf16_production")
    tc, sw = cfg.train, cfg.sweep
    if (tc.compute_dtype, tc.ema_rate, tc.parameterization, sw.sampler,
            sw.backward_method, sw.corrector_steps,
            sw.num_stepss_backward, sw.batch_sizes[0]) != (
            "bfloat16", 0.999, "eps", "sde", "em", PROD_CORRECTOR,
            (PROD_STEPS,), TRAIN_BATCH):
        raise AssertionError(f"grf16_production: {tc}, {sw}")
    rec = {"card": card, "args": PROD_ARGS}

    # (a) the SGM arm's bf16 SSM loss and gradients, kernel against plain
    model, gen = build_sgm_arm(cfg, None, device=dev)
    randomize_(model, g)
    with torch.no_grad():  # a gentler score head, as for the MSGM arm
        model.core.conv_out.weight.mul_(0.1)
    sampler = drv.make_sampler(cfg, DIM, device=dev)
    x = sampler.sample(g, TRAIN_BATCH)
    draws = dict(t=gen.sample_t(g, TRAIN_BATCH),
                 noise=torch.randn(TRAIN_BATCH, DIM, generator=g, device=dev),
                 v=sample_v(g, (TRAIN_BATCH, DIM), gen.vtype, device=dev))
    # the same loss's gradients in fp32, to measure both bf16 paths by
    fp32 = dataclasses.replace(cfg, train=dataclasses.replace(
        tc, compute_dtype="float32"))
    model32 = drv.make_model(fp32, DIM, None, device=dev)
    model32.load_state_dict(model.state_dict())
    gen32 = dataclasses.replace(gen, score_net=model32)
    with plain_path():
        gen32.ssm(g, x, **draws).mean().backward()
    exact = {n: p.grad.detach().clone()
             for n, p in model32.named_parameters()}
    del model32, gen32
    rec["ssm_agreement"] = train_agreement(
        model, gen.ssm, g, x, draws, sgm_ssm_want(), PROD_LOSS_TOL,
        PROD_GRAD_TOL, exact)
    trainer = drv.make_trainer(cfg, gen, sampler, TRAIN_BATCH, log_fn=log)
    rec["ssm_profile"] = trace(lambda: trainer.train_step(
        trainer.state, g, sampler.sample(g, TRAIN_BATCH)))
    log_trace(f"one bf16 SGM SSM train step at batch {TRAIN_BATCH}",
              rec["ssm_profile"])
    del model, gen, trainer
    rec["request_profile"] = pc_request_profile(cfg, g, dev)
    rec.update(production_run(g, dev, card, PROD_ARGS, "auto"))
    return rec


def pc_request_profile(cfg, g, dev):
    """Where a production request's time goes: a trace of 2 PC steps of
    cfg's MSGM arm (random weights) at 1,024 samples."""
    from sdeflow_tpu_torch import build_msgm_arm, make_sampler_fn

    sw = cfg.sweep
    model, gen = build_msgm_arm(cfg, g, device=dev)
    randomize_(model, g)
    with torch.no_grad():
        model.core.conv_out.weight.mul_(0.1)
    pc2 = make_sampler_fn(gen, N_SAMPLES, DIM, PROFILED_STEPS,
                          method=sw.backward_method, norm_correction=True,
                          corrector_steps=sw.corrector_steps, snr=sw.snr,
                          device=dev)
    prof = dict(trace(lambda: pc2(g)), steps=PROFILED_STEPS)
    log_trace(f"{PROFILED_STEPS} PC steps (EM + {PROD_CORRECTOR} corrector)"
              f" of {N_SAMPLES} samples, {cfg.train.attention_impl} route",
              prof)
    return prof


def unfused_production():
    """grf16_production on the unfused attention route."""
    from sdeflow_tpu_torch import get_preset

    cfg = get_preset("grf16_production")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, attention_impl="unfused"))


def production_run(g, dev, card, args, route, replay=True):
    """``sdeflow_tpu_torch.run.main`` with args (a grf16_production run)
    with its checks: every kernel count set to 0 just before and read just
    after; each arm's bf16 steps with the launches of an SSM step on the
    AttentionBlock route, finite losses, moving parameters, parameters,
    Adam moments and EMA in fp32; each arm's request with the route's
    launches per net evaluation, and no float32 entry of an attention
    kernel; with replay, the MSGM request replayed on the plain path
    (replay_gates); the metrics."""
    import tempfile

    import numpy as np

    from sdeflow_tpu_torch import run as run_mod
    from sdeflow_tpu_torch.eval.diagnostics import filter_blowups
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops import integrators
    from sdeflow_tpu_torch.ops.kernels import common

    rec = {"card": card, "args": args, "route": route}
    # (b) the CLI's run, its kernels' launches counted from 0; every
    # corrector call's step size recorded
    steps, gens, scores, corr = [], [], [], []
    orig_corrector = integrators.langevin_corrector

    def corrector(*a, **k):
        out = orig_corrector(*a, **k)
        corr.append(out[1])
        return out

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        argv = [*args, "--results-dir", os.path.join(tmp, "results")]
        os.chdir(tmp)
        try:
            # with replay, cuDNN's deterministic algorithms: its default
            # backward sums in an order that varies from run to run, and so
            # did the trained weights, the trajectories and the extremes
            # that the replay gates compare (on an H100, eight runs read
            # kernel - plain 0.013-0.100 of the rms, and from the fp32 run
            # the kernel run 0.021-0.111, the plain bf16 run 0.029-0.153)
            with counted_steps(steps), spied(drv, "generate", gens), \
                    spied(drv, "postprocessing", scores), \
                    swapped([(integrators, "langevin_corrector",
                              corrector)] + replay * [
                                  (torch.backends.cudnn, "deterministic",
                                   True)]):
                common.reset_launches()
                t0 = time.perf_counter()
                results = run_mod.main(argv)
                torch.cuda.synchronize()
                rec["driver_s"] = time.perf_counter() - t0
                rec["launches"] = launch_counts()
                rec["entry_launches"] = entry_counts()
        finally:
            os.chdir(cwd)
    log(f"production run ({route} route): {rec['driver_s']:.1f} s, launches "
        f"{rec['launches']}")
    must = [("qkv_attention" if route == "unfused"
             and k == "fused_attention_block" else k) for k in DRIVER_KERNELS]
    missing = [k for k in must if not rec["launches"][k]]
    if missing or f32_attention_launches():
        raise AssertionError(f"the production run never launched {missing}"
                             f" or launched {f32_attention_launches()}")

    # (c) training: both arms in bf16, fp32 parameters, moments and EMA
    arms = {"SGM": "SGM", "MSGM": "MSGM_sparseTenslogNorm"}
    rec["train"] = {}
    for arm, sde_name in arms.items():
        mine = [r for r in steps if r["arm"] == sde_name]
        want = train_want(route) if arm == "MSGM" else sgm_ssm_want(route)
        if len(mine) != DRIVER_ITERATIONS:
            raise AssertionError(f"{arm}: {len(mine)} train steps")
        bad = [r["launches"] for r in mine if r["launches"] != want]
        if bad:
            raise AssertionError(f"{arm} step launches {bad[0]} != {want}")
        losses = torch.stack([r["loss"] for r in mine])
        state, opt = mine[-1]["state"], mine[-1]["optimizer"]
        moved = max((p.detach() - q).abs().max().item() for p, q in zip(
            state.params.values(), mine[0]["params_before"]))
        dtypes = {str(t.dtype) for t in (
            *state.params.values(), *state.ema_params.values(),
            *(v for st in opt.state.values() for v in st.values()
              if isinstance(v, torch.Tensor) and v.ndim))}
        net = state.gen_sde.score_net
        if not (torch.isfinite(losses).all() and moved > 0
                and dtypes == {"torch.float32"}
                and net.core.conv_in.compute_dtype == torch.bfloat16):
            raise AssertionError(f"{arm}: losses {losses}, moved {moved}, "
                                 f"dtypes {dtypes}")
        ms = [r["ms"] for r in mine]
        rec["train"][arm] = dict(
            ms_per_step=ms, ms_per_step_after_first=sum(ms[1:]) / len(ms[1:]),
            max_memory_allocated=max(r["peak"] for r in mine),
            launches_per_step=mine[-1]["launches"], losses=losses.tolist(),
            param_moved=moved, state_dtypes=sorted(dtypes))
        log(f"{card}: {arm} bf16 SSM steps at batch {TRAIN_BATCH}: "
            f"{rec['train'][arm]['ms_per_step_after_first']:.1f} ms/step "
            f"(steps 2-{DRIVER_ITERATIONS}; the first {ms[0]:.1f} ms), peak "
            f"{rec['train'][arm]['max_memory_allocated'] / 2**20:.1f} MiB; "
            f"parameters, Adam moments and EMA {sorted(dtypes)}")

    # (d) generation: EM-32 plus one corrector step per arm
    if len(gens) != 2 or len(corr) != 2 * PROD_STEPS:
        raise AssertionError(f"{len(gens)} generation runs, {len(corr)} "
                             "corrector calls")
    rec["generate"] = {}
    want = prod_gen_want(route)
    for i, ((arm, is_msgm), r) in enumerate(zip(
            (("SGM", False), ("MSGM", True)), gens)):
        xs = r["out"]
        if tuple(xs.shape) != (PROD_STEPS + 1, N_SAMPLES, DIM) or \
                not torch.isfinite(xs).all():
            raise AssertionError(f"{arm}: trajectory {tuple(xs.shape)}")
        got = {k: r["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"{arm} request launches {got} != {want}")
        norms = xs.norm(dim=2)
        kept = bool(torch.allclose(norms, norms[0].expand_as(norms),
                                   rtol=1e-5, atol=0))
        if kept is not is_msgm:
            raise AssertionError(f"{arm}: norms kept = {kept}")
        eps = torch.cat(corr[i * PROD_STEPS:(i + 1) * PROD_STEPS]).tolist()
        stepped = sum(e > 0 for e in eps)
        if not (stepped and all(math.isfinite(e) for e in eps)):
            raise AssertionError(f"{arm}: corrector step sizes {eps}")
        rec["generate"][arm] = dict(
            ms=r["ms"], launches=r["launches"], peak=r["peak"],
            norms_kept=kept, corrector_eps=eps, corrector_steps_taken=stepped,
            k1_per_step=r["launches"]["circulant_apply"] / PROD_STEPS)
        log(f"{card}: {arm} production request of {N_SAMPLES} samples x "
            f"{PROD_STEPS} EM steps + {PROD_CORRECTOR} corrector step "
            f"(trajectory kept): {r['ms']:.1f} ms, launches {r['launches']},"
            f" norms kept {kept}; corrector stepped (ε > 0) on {stepped} of "
            f"{PROD_STEPS} steps, ε {min(eps):.3g} to {max(eps):.3g}")
    # the MSGM request replayed on the plain path (same x0 and draws), and
    # on the plain path computing in fp32: bf16's own distance
    if replay:
        r = gens[1]

        def rerun(fp32=False):
            replay_g = torch.Generator(device=dev)
            replay_g.set_state(r["generator_states"][0])
            call = list(r["args"])
            call[1] = replay_g
            saved = {m: m.compute_dtype for m in call[0].score_net.modules()
                     if hasattr(m, "compute_dtype")}
            common.reset_launches()
            try:
                for m in saved:
                    m.compute_dtype = torch.float32 if fp32 else saved[m]
                with plain_path():
                    out = drv.generate(*call, **r["kwargs"])
            finally:
                for m, dt in saved.items():
                    m.compute_dtype = dt
            if any(launch_counts().values()):
                raise AssertionError(
                    f"plain replay launched {launch_counts()}")
            return out

        xp = rerun()
        x32 = rerun(fp32=True)
        rep = replay_errs(r["out"], xp, filter_blowups)
        own = replay_errs(xp, x32, filter_blowups)  # bf16's own distance
        kf = replay_errs(r["out"], x32, filter_blowups)
        rec["generate"]["MSGM"].update(plain_replay=rep,
                                       bf16_against_fp32=own,
                                       kernel_against_fp32=kf)
        replay_gates("MSGM production request", rep, own, kf)

    # (e) the metrics
    for k in drv.METRICS:
        if results[k].shape != (1, 1, 1, 1, 1) or \
                not np.isfinite(results[k]).all():
            raise AssertionError(f"results[{k!r}] = {results[k]}")
    rec["metrics"] = {}
    for arm, c in zip(("SGM", "MSGM"), scores):
        o = c["out"]
        rec["metrics"][arm] = dict(sqrt_mmd=o["mmd"] ** 0.5, swd=o["swd"],
                                   sqrt_mmd_floor=o["mmd_ref"] ** 0.5,
                                   nan_count=o["nan_count"])
        log(f"{card}: production {arm}: sqrt-MMD {o['mmd'] ** 0.5:.5f}, SWD "
            f"{o['swd']:.5f} (floor {o['mmd_ref'] ** 0.5:.5f}, "
            f"{o['nan_count']} rows dropped)")
    return rec


# phase 23: the bf16 variants of K6, K4, K7a and K7b against their plain
# twins: the paths' shapes (grf16's unfused blocks in the request and the
# SSM step, whose K6 tiles pack 4 and 1 units at T = 16, the DSM step's
# T = 1024 level, the T = 4096 blocks), two heads, a head width of 128 and a
# ragged T
K6_BF16_SHAPES = [(1024, 64, 64, 1), (1024, 64, 64, 4), (1024, 16, 128, 1),
                  (TRAIN_BATCH, 64, 64, 1), (TRAIN_BATCH, 16, 128, 1),
                  (128, 1024, 128, 1)]
K4_BF16_SHAPES = [(4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1)]
K7_BF16_SHAPES = K4_BF16_SHAPES + [(2, 1000, 64, 1)]
# K4 and K7a bf16 (not K7b) also at the request's and the DSM step's
# shapes, whose grids take the two-warpgroup block (flash_fwd_bf16_rows:
# 128 rows); the shapes above all take the one-warpgroup block
K4_K7A_BF16_WIDE = [(16, 4096, 64, 1), (SGM_BATCH, 4096, 64, 1)]
# two gates, both held: within 2e-2·max |plain bf16| of the plain bf16 twin
# (two bf16 ulps: the kernels round where the JAX kernel bodies do, the
# twins of K6 and K4 where the JAX math versions do), and no farther from
# the fp32 plain version on the widened bf16 inputs than 1.5× the plain
# bf16 twin's own distance from it plus 1e-3·max (the rule of
# tests/test_torch_bf16.py; a gate at bf16's size alone passes a kernel
# fault of that size). K7b's dqkv is held to attention_flash_bwd_math in
# bf16 (fp32 math rounded once on both sides: about one bf16 ulp apart) at
# 1e-2·max. K7a's lse against the fp32 plain version's (the same fp32
# scores, the products exact on both sides, summed in another order):
# 1e-5, fp32 K7a's bound (phase 17), from the first readings (2.86e-6 to
# 3.81e-6 over K7_BF16_SHAPES)
ATTN_BF16_TOL, K7B_BF16_TOL, K7A_BF16_LSE_TOL = 2e-2, 1e-2, 1e-5
# where the bf16 kernels are timed: K4, K7a and K7b at the long-sequence
# block's and the DSM step's T = 4096 shapes, K6 at the DSM step's T = 1024
# level and at grf16's two unfused shapes (path (a)'s mix)
ATTN_BF16_LONG = [(4, 4096, 64), (SGM_BATCH, 4096, 64)]
K6_BF16_DSM = (SGM_BATCH, 1024, 128)
# K4 bf16 timed by --only attn_bf16: the long-sequence block's shape and
# phase 24's request's (batch 16 at T = 4096)
K4_BF16_TIMED = [(4, 4096, 64), (16, 4096, 64)]


def k6_bf16_cost(b, t, c, heads):
    # K6's work with qkv read and out written in bf16
    _, products, other = k6_cost(b, t, c, heads)
    return 8 * b * t * c, products, other


def k7a_bf16_cost(b, t, c, heads):
    # and lse written in fp32
    nbytes, products, other = k6_bf16_cost(b, t, c, heads)
    return nbytes + 4 * b * heads * t, products, other


def k7b_bf16_cost(b, t, c, heads):
    # qkv, dO read and dqkv written in bf16, lse and Δ read in fp32; the
    # five products once (the split of P and dS into two bf16 halves is the
    # kernel's choice, not the function's work)
    _, products, other = k7b_cost(b, t, c, heads)
    return 2 * b * t * 7 * c + 8 * b * heads * t, products, other


def entry_counts():
    """Launches per C entry point of every kernel since the last reset."""
    from sdeflow_tpu_torch.ops.kernels import common

    return {e: n for k in common.KERNELS.values()
            for e, n in k.entry_launches.items()}


def f32_attention_launches():
    """The float32 entries of K6, K4, K7a and K7b that launched since the
    last reset (none on a bf16 path)."""
    return {e: n for e, n in entry_counts().items()
            if e.startswith("qkv_attention") and e.endswith("_f32") and n}


def bf16_gates(name, out, plain, fp32, tol):
    """Both gates of phase 23; (distance from the plain bf16 twin, from
    the fp32 plain, the plain twin's own from it), relative to the max."""
    out, plain = out.float(), plain.float()
    scale, scale32 = plain.abs().max().item(), fp32.abs().max().item()
    err = (out - plain).abs().max().item() / scale
    mine = (out - fp32).abs().max().item() / scale32
    theirs = (plain - fp32).abs().max().item() / scale32
    ok = (bool(torch.isfinite(out).all()) and err <= tol
          and mine <= 1.5 * theirs + 1e-3)
    log(f"  {name}: max |kernel - plain bf16| / max = {err:.3g} (tolerance "
        f"{tol:g}); from the fp32 plain: kernel {mine:.3g}, plain bf16 "
        f"{theirs:.3g} (the kernel's bound {1.5 * theirs + 1e-3:.3g})")
    if not ok:
        raise AssertionError(f"bf16 {name} disagrees with its plain twin")
    return err, mine, theirs


def k4_k7a_bits(ak, qkv, heads, out):
    """K4 bf16's out (given) against K7a bf16's on the same qkv, and K7a
    bf16 run twice: equal bit for bit (one body under two symbols, every
    sum in one warpgroup's registers)."""
    runs = [ak._launch_stats(qkv, heads) for _ in range(2)]
    torch.cuda.synchronize()
    same = (torch.equal(out.view(torch.int16), runs[0][0].view(torch.int16)),
            torch.equal(runs[0][0].view(torch.int16),
                        runs[1][0].view(torch.int16)),
            torch.equal(runs[0][1].view(torch.int32),
                        runs[1][1].view(torch.int32)))
    log(f"  K4 out equal to K7a out bit for bit: {same[0]}; K7a again: out "
        f"{same[1]}, lse {same[2]}")
    if not all(same):
        raise AssertionError(f"bf16 K4/K7a bit for bit: {same}")


# an "auto" AttentionBlock at T = 256 with 8 heads that fp32 K3 holds with
# qkv in scratch and bf16 K3 in shared memory: (B, C, H, W) and heads; 32
# groups
AUTO_BEYOND_K3, AUTO_BEYOND_K3_HEADS = (4, 64, 16, 16), 8


def auto_block_beyond_k3(g, dev):
    """The bf16 "auto" block at AUTO_BEYOND_K3 runs on K3 bf16 (one K3
    launch, no K5, no K6; it ran unfused while bf16 K3 held only blocks
    that fit shared memory whole) and holds phase 23's gates against the
    plain path in bf16 and in fp32."""
    from sdeflow_tpu_torch.models.unet2d import AttentionBlock
    from sdeflow_tpu_torch.ops.kernels.attnblock import block_plan

    b, c, h, w = AUTO_BEYOND_K3
    heads = AUTO_BEYOND_K3_HEADS
    if (block_plan(h * w, c, 32, heads) is None
            or block_plan(h * w, c, 32, heads, torch.bfloat16) is None):
        raise AssertionError("K3's plans moved: pick another shape")
    block = AttentionBlock(c, heads).to(dev)
    randomize_(block, g)
    x = (1.5 * torch.randn(b, c, h, w, generator=g, device=dev)).to(
        torch.bfloat16)
    before, entries0 = launch_counts(), entry_counts()
    with torch.no_grad():
        out = block(x)
        torch.cuda.synchronize()
        got = {k: n - before[k] for k, n in launch_counts().items()}
        entries = {e: n - entries0[e] for e, n in entry_counts().items()}
        with plain_path():
            plain, fp32 = block(x), block(x.float())
    want = {k: 0 for k in got}
    want.update(fused_attention_block=1)
    if got != want or entries["attn_block_bf16"] != 1:
        raise AssertionError(f"the bf16 auto block launched {got}")
    log(f"bf16 auto block {AUTO_BEYOND_K3} heads={heads} (T = 256): K3 "
        f"bf16, launches {got}")
    return bf16_gates("auto block", out, plain, fp32, ATTN_BF16_TOL)


def check_attention_bf16(g, dev):
    """Phase 23: the bf16 entries of K6, K4, K7a and K7b against their
    plain twins (both gates; TF32 off, and the plain twins' bf16 products
    summed in fp32; K4 and K7a in both their blocks, K4's out against
    K7a's, K6 and K7a against themselves bit for bit), then their times
    per call through the Function and as
    direct launches beside the plain twins, SDPA in bf16 (forward;
    backward for K7b) and the bounds (bf16 products at 989 TFLOP/s)."""
    from sdeflow_tpu_torch.ops.kernels import attention as ak

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf = torch.bfloat16
    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    errs = collections.defaultdict(float)

    def note(name, e):
        errs[name] = max(errs[name], e[0])
        errs[name + "_from_fp32"] = max(errs[name + "_from_fp32"], e[1])
        errs[name + "_plain_from_fp32"] = max(
            errs[name + "_plain_from_fp32"], e[2])

    def draw(b, t, c, scale=1.5):
        return (scale * torch.randn(b, t, c, generator=g, device=dev)).to(bf)

    # K4 and K7a's one- and two-warpgroup blocks are both held
    narrow, wide = ({ak.flash_fwd_bf16_rows(b, t, heads)
                     for b, t, _, heads in shapes}
                    for shapes in (K7_BF16_SHAPES, K4_K7A_BF16_WIDE))
    if (narrow, wide) != ({64}, {128}):
        raise AssertionError(f"bf16 K4/K7a rows per block {narrow}, {wide}:"
                             " pick other shapes")
    entries0 = entry_counts()
    with torch.no_grad():
        for b, t, c, heads in (K6_BF16_SHAPES + K4_BF16_SHAPES
                               + K4_K7A_BF16_WIDE):
            name = "K4" if t > 1024 else "K6"
            qkv = draw(b, t, 3 * c)
            out = ak._launch(qkv, heads)
            if name == "K6":  # bit for bit on a second run
                again = ak._launch(qkv, heads)
                torch.cuda.synchronize()
                if not bits_equal(out, again):
                    raise AssertionError(f"bf16 K6 at {(b, t, c, heads)}: "
                                         "a second run differs")
            torch.cuda.synchronize()
            log(f"bf16 {name} ({b}, {t}, {c}) heads={heads}:")
            note(name, bf16_gates(name, out, ak.attention_reference(
                qkv, heads), ak.attention_reference(qkv.float(), heads),
                ATTN_BF16_TOL))
            if name == "K4":
                k4_k7a_bits(ak, qkv, heads, out)
            del qkv, out
        for b, t, c, heads in K7_BF16_SHAPES + K4_K7A_BF16_WIDE:
            qkv = draw(b, t, 3 * c)
            out, lse = ak._launch_stats(qkv, heads)
            torch.cuda.synchronize()
            out_p, _ = ak.attention_flash_stats_math(qkv, heads)
            out32, lse32 = ak.attention_flash_stats_math(qkv.float(), heads)
            k7b = (b, t, c, heads) in K7_BF16_SHAPES
            log(f"bf16 K7a{'/K7b' if k7b else ''} ({b}, {t}, {c}) "
                f"heads={heads}:")
            note("K7a", bf16_gates("K7a", out, out_p, out32, ATTN_BF16_TOL))
            e_lse = (lse - lse32).abs().max().item()
            errs["K7a_lse"] = max(errs["K7a_lse"], e_lse)
            log(f"  K7a lse: max |kernel - fp32 plain| = {e_lse:.3g} "
                f"(tolerance {K7A_BF16_LSE_TOL:g})")
            if not e_lse <= K7A_BF16_LSE_TOL:
                raise AssertionError(f"bf16 K7a's lse: {e_lse}")
            if not k7b:
                del qkv, out, lse, out_p, out32, lse32
                continue
            dout = draw(b, t, c, 1.0)
            delta = (ak._heads(dout, heads).float()
                     * ak._heads(out_p, heads).float()).sum(-1)
            dqkv = ak._launch_bwd(qkv, dout, lse32, delta, heads)
            again = ak._launch_bwd(qkv, dout, lse32, delta, heads)
            torch.cuda.synchronize()
            # one writer per element, sums in registers: bit for bit
            if not torch.equal(dqkv.view(torch.int16),
                               again.view(torch.int16)):
                raise AssertionError("bf16 K7b differs from run to run")
            note("K7b", bf16_gates(
                "K7b", dqkv,
                ak.attention_flash_bwd_math(qkv, dout, lse32, delta, heads),
                ak.attention_flash_bwd_math(qkv.float(), dout.float(), lse32,
                                            delta, heads), K7B_BF16_TOL))
            del qkv, dout, out, lse, out_p, out32, lse32, delta, dqkv, again
    launched = {e: n - entries0[e] for e, n in entry_counts().items()}
    n_k4 = len(K4_BF16_SHAPES) + len(K4_K7A_BF16_WIDE)
    want = {"qkv_attention_bf16": 2 * len(K6_BF16_SHAPES),
            "qkv_attention_flash_bf16": n_k4,
            "qkv_attention_stats_bf16": (len(K7_BF16_SHAPES)
                                         + len(K4_K7A_BF16_WIDE) + 2 * n_k4),
            "qkv_attention_bwd_bf16": 2 * len(K7_BF16_SHAPES)}
    if {e: launched[e] for e in want} != want or f32_attention_launches():
        raise AssertionError(f"phase 23 launched {launched}")
    note("auto_block", auto_block_beyond_k3(g, dev))

    # times: K6 at grf16's unfused shapes and the DSM step's T = 1024
    rows = {"k6": [], "k4": [], "k7a": [], "k7b": []}
    for b, t, c in [s[:3] for s in K6_BF16_SHAPES if s[3] == 1]:
        qkv = draw(b, t, 3 * c)
        q, k, v = sdpa_args(qkv, 1)
        iters = 50 if b * t * t <= 2**24 else 10
        bound, by = bound_bf16_ms(*k6_bf16_cost(b, t, c, 1))
        with torch.no_grad():
            rows["k6"].append({
                "shape": [b, t, c], "heads": 1,
                "ms": cuda_ms(lambda: ak.qkv_attention(qkv, 1), iters),
                "direct_ms": cuda_ms(lambda: ak._launch(qkv, 1), iters),
                "plain_ms": cuda_ms(lambda: ak.attention_math(qkv, 1), iters),
                "library_ms": cuda_ms(lambda: sdpa(q, k, v), iters),
                "bound_ms": bound, "bound_by": by})
        del qkv, q, k, v
    # K4, K7a and K7b at T = 4096
    for b, t, c in ATTN_BF16_LONG:
        few = b > 16
        it_f, it_b, it_p = (5, 3, 2) if few else (50, 20, 5)
        qkv, dout = draw(b, t, 3 * c), draw(b, t, c, 1.0)
        x = qkv.detach().requires_grad_()
        y = ak.flash_attention_vjp(x, 1)
        q, k, v = (a.requires_grad_() for a in sdpa_args(qkv, 1))
        o = sdpa(q, k, v)
        do = ak._heads(dout, 1).contiguous()
        with torch.no_grad():
            out, lse = ak._launch_stats(qkv, 1)
            delta = (ak._heads(dout, 1).float()
                     * ak._heads(out, 1).float()).sum(-1)
            lib_fwd = cuda_ms(lambda: sdpa(q, k, v), it_f, 1)
            for key, cost, fn, direct, plain in [
                    ("k4", k6_bf16_cost, lambda: ak.qkv_attention(qkv, 1),
                     lambda: ak._launch(qkv, 1),
                     lambda: ak.attention_flash_math(qkv, 1)),
                    ("k7a", k7a_bf16_cost,
                     lambda: ak.flash_attention_vjp(qkv, 1),
                     lambda: ak._launch_stats(qkv, 1),
                     lambda: ak.attention_flash_stats_math(qkv, 1))]:
                bound, by = bound_bf16_ms(*cost(b, t, c, 1))
                rows[key].append({
                    "shape": [b, t, c], "heads": 1,
                    "ms": cuda_ms(fn, it_f, 1),
                    "direct_ms": cuda_ms(direct, it_f, 1),
                    "plain_ms": cuda_ms(plain, it_p, 1),
                    "library_ms": lib_fwd, "bound_ms": bound, "bound_by": by})
            bound, by = bound_bf16_ms(*k7b_bf16_cost(b, t, c, 1))
            r7b = {
                "shape": [b, t, c], "heads": 1,
                "direct_ms": cuda_ms(lambda: ak._launch_bwd(
                    qkv, dout, lse, delta, 1), it_b, 1),
                "plain_ms": cuda_ms(lambda: ak.attention_flash_bwd_math(
                    qkv, dout, lse, delta, 1), it_p, 1),
                "bound_ms": bound, "bound_by": by}
        r7b["ms"] = cuda_ms(lambda: torch.autograd.grad(
            y, x, dout, retain_graph=True), it_b, 1)
        r7b["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True), it_b, 1)
        rows["k7b"].append(r7b)
        del qkv, dout, x, y, q, k, v, o, do, out, lse, delta
    mm.allow_bf16_reduced_precision_reduction = reduced
    for key, shapes in rows.items():
        for r in shapes:
            log(f"bf16 {key.upper()} at {r['shape']}: {r['ms']:.4f} ms per "
                f"call (direct {r['direct_ms']:.4f}), plain "
                f"{r['plain_ms']:.4f}, SDPA bf16 {r['library_ms']:.4f}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return dict(rows, max_errs=dict(errs))


# phase 24: the grf U-Net at 128×128 in bf16 (phase 18's cell with the
# production preset's score-net knobs: bf16 compute, eps) trained by DSM at
# batch 128 and served by a reduced no-grad request at batch 16 (4 EM steps
# and one corrector step each; the model at full width)
DSM_BF16_REQUEST, DSM_BF16_STEPS = 16, 4
# the production replay's gate on its first predictor-corrector step: max
# |kernel − plain| / rms of the state after one step (the MSGM replays
# read 3e-4 to 4e-4 there on an H100; a bf16 ulp of the largest entry is
# ~10× that). Phase 24's reduced request takes 4 steps, so its first step
# carries a quarter of the way, and after it the plain bf16 run itself
# lay 0.046-0.054 of the rms from the fp32 run on an H100: it
# holds its first step relatively instead, the kernel run no farther from
# the fp32 run than 1.5× the plain bf16 run at that state
PROD_FIRST_STEP_TOL = 2e-3


def replay_gates(what, rep, own, kf, first_absolute=True):
    """The production request's replay gates (phase 22's): kernel − plain
    within PROD_REPLAY_TOL of each state's rms, or the kernel run no
    farther from the fp32 run than 1.5× the plain bf16 run; and, held
    besides, after the first predictor-corrector step, kernel − plain
    within PROD_FIRST_STEP_TOL (first_absolute) or the kernel run no
    farther from the fp32 run than 1.5× the plain bf16 run there."""
    first = rep["rel_per_state"][1]
    first_ok = (first <= PROD_FIRST_STEP_TOL if first_absolute else
                kf["rel_per_state"][1] <= 1.5 * own["rel_per_state"][1])
    held = ("" if first_absolute else
            f"; held instead: from fp32 there the kernel run "
            f"{kf['rel_per_state'][1]:.3g}, the plain bf16 run "
            f"{own['rel_per_state'][1]:.3g}")
    log(f"{what} replayed plain on the {rep['rows_kept']} rows that "
        f"filter_blowups keeps: max over states of max |kernel - plain| / "
        f"rms(plain) = {rep['rel']:.3g} at state {rep['state']} (max |Δ| "
        f"{rep['max_abs_err']:.3g}, rms {rep['rms']:.3g}; tolerance "
        f"{PROD_REPLAY_TOL:g}), after the first step {first:.3g} (tolerance "
        f"{PROD_FIRST_STEP_TOL:g}{held}); against the same request in fp32, "
        f"max |Δ| / rms the kernel run {kf['rel']:.3g}, the plain bf16 run "
        f"{own['rel']:.3g}; rms |Δ| / rms {kf['rms_rel']:.3g} and "
        f"{own['rms_rel']:.3g} (kernel-plain {rep['rms_rel']:.3g}); per "
        f"state kernel-plain {[round(v, 5) for v in rep['rel_per_state']]}")
    ok = rep["rel"] <= PROD_REPLAY_TOL or (
        kf["rms_rel"] <= 1.5 * own["rms_rel"]
        and kf["rel"] <= 1.5 * own["rel"] + PROD_REPLAY_TOL)
    if not (ok and first_ok):
        raise AssertionError(
            f"{what}: kernel and plain disagree (whole run "
            f"{'held' if ok else 'failed'}: kernel-plain {rep['rel']:.3g}, "
            f"from fp32 kernel {kf['rel']:.3g} / {kf['rms_rel']:.3g} rms, "
            f"plain bf16 {own['rel']:.3g} / {own['rms_rel']:.3g} rms; first "
            f"step {'held' if first_ok else 'failed'}: kernel-plain "
            f"{first:.3g}, from fp32 kernel {kf['rel_per_state'][1]:.3g}, "
            f"plain bf16 {own['rel_per_state'][1]:.3g})")


def bf16_dsm_arm(g, dev):
    """The SGM arm of _grf(128) with the production preset's score-net
    knobs (bf16 compute, eps) and random weights; its train config and
    sampler as sgm_arm's."""
    from sdeflow_tpu_torch import build_sgm_arm
    from sdeflow_tpu_torch.configs import _grf
    from sdeflow_tpu_torch.experiments.driver import make_sampler

    cfg = _grf(SGM_NPIXEL)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16", parameterization="eps"))
    model, gen = build_sgm_arm(cfg, g, device=dev)
    randomize_(model, g)
    with torch.no_grad():
        model.core.conv_out.weight.mul_(0.1)
    return cfg, model, gen, make_sampler(cfg, SGM_NPIXEL**2, dev)


def bf16_request(gen, dev):
    """Phase 24's no-grad request on gen: EM with one corrector step, the
    production preset's knobs, reduced to batch DSM_BF16_REQUEST and
    DSM_BF16_STEPS steps; (sweep knobs, sampler fn(g))."""
    from sdeflow_tpu_torch import get_preset, make_sampler_fn

    sw = get_preset("grf16_production").sweep
    return sw, make_sampler_fn(gen, DSM_BF16_REQUEST, SGM_NPIXEL**2,
                               DSM_BF16_STEPS, method=sw.backward_method,
                               keep_all=True, include_t0=True,
                               corrector_steps=sw.corrector_steps,
                               snr=sw.snr, device=dev)


def check_bf16_request(r):
    """A timed_call record of bf16_request's sampler: its exact launches,
    no float32 attention entry since the last reset, and finite samples of
    the expected shape; returns the launches."""
    from sdeflow_tpu_torch.ops.kernels import common

    want = dsm_bf16_request_want()
    got = {k: r["launches"][k] for k in common.KERNELS}
    xs = r["out"]
    if (got != {k: want.get(k, 0) for k in got}
            or f32_attention_launches() or not torch.isfinite(xs).all()
            or tuple(xs.shape) != (DSM_BF16_STEPS + 1, DSM_BF16_REQUEST,
                                   SGM_NPIXEL**2)):
        raise AssertionError(f"bf16 request: launches {got}, "
                             f"{f32_attention_launches()}, "
                             f"{tuple(xs.shape)}")
    return got


def dsm_bf16_request_want():
    """Launches of the reduced request: per net evaluation the U-Net's 46
    GroupNorms, its 5 blocks at T = 4096 (K4) and 6 at T = 1024 (K6)."""
    evals = PROD_EVALS_PER_STEP * DSM_BF16_STEPS
    blocks = {t: n for (_, t), n in SGM_BLOCKS.items()}
    return {"group_norm_silu": 46 * evals,
            "qkv_attention_flash": blocks[4096] * evals,
            "qkv_attention": blocks[1024] * evals}


def check_dsm_bf16(g, dev, card, fp32_peak=None):
    """Phase 24: the bf16 grf U-Net at 128×128: the DSM loss and every
    gradient, kernel path against plain on one batch of 8; two Trainer
    steps; 5 timed bare steps at batch 128 with exact launches and peak
    memory; one traced step; the reduced no-grad request with its exact
    launches, a trace, and a replay on the plain path (bf16 and fp32)."""
    from sdeflow_tpu_torch import Trainer
    from sdeflow_tpu_torch.eval.diagnostics import filter_blowups
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops.kernels import common

    cfg, model, gen, sampler = bf16_dsm_arm(g, dev)
    tc, dim = cfg.train, SGM_NPIXEL**2
    want = {k: SGM_WANT.get(k, 0) for k in common.KERNELS}
    log(f"bf16 SGM arm of grf{SGM_NPIXEL}: compute {tc.compute_dtype}, "
        f"parameterization {tc.parameterization}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    # (a) the kernel path against the plain path on one batch of 8, each
    # measured against the same loss's gradients in fp32
    b = SGM_AGREE_BATCH
    x = sampler.sample(g, b)
    draws = dict(t=gen.sample_t(g, b),
                 noise=torch.randn(b, dim, generator=g, device=dev))
    fp32 = dataclasses.replace(cfg, train=dataclasses.replace(
        tc, compute_dtype="float32"))
    model32 = drv.make_model(fp32, dim, None, device=dev)
    model32.load_state_dict(model.state_dict())
    gen32 = dataclasses.replace(gen, score_net=model32)
    with plain_path():
        gen32.dsm(g, x, **draws).mean().backward()
    exact = {n: p.grad.detach().clone()
             for n, p in model32.named_parameters()}
    del model32, gen32
    common.reset_launches()
    rec = {"agreement": train_agreement(
        model, gen.dsm, g, x, draws, want, PROD_LOSS_TOL, PROD_GRAD_TOL,
        exact, bf16_only=True)}

    # (b) the Trainer: two DSM steps with ELBO prints
    t0 = time.perf_counter()
    trainer = Trainer(gen, sampler, lr=tc.lr, batch_size=SGM_BATCH,
                      loss="dsm", log_fn=log)
    state, loss = trainer.run(g, 2, x_test=sampler.sample(g, SGM_BATCH))
    torch.cuda.synchronize()
    rec["trainer_s"] = time.perf_counter() - t0
    if not (state.step == 2 and math.isfinite(loss)
            and all(math.isfinite(h["elbo"]) for h in trainer.history)):
        raise AssertionError(f"bf16 SGM Trainer: step {state.step}, {loss},"
                             f" {trainer.history}")

    def step():
        return trainer.train_step(trainer.state, g,
                                  sampler.sample(g, SGM_BATCH))[1]

    # (c) timed bare steps at batch 128, bf16 entries only
    rec.update(timed_train_steps(step, model, SGM_TIMED_STEPS, want,
                                 SGM_BATCH))
    if f32_attention_launches():
        raise AssertionError(f"bf16 DSM steps: {f32_attention_launches()}")
    dtypes = {str(p.dtype) for p in model.parameters()}
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"parameters {dtypes}")
    log(f"{card}: bf16 DSM step at batch {SGM_BATCH}: "
        f"{rec['ms_per_step']:.1f} ms, peak "
        f"{rec['max_memory_allocated'] / 2**20:.1f} MiB (fp32, phase 18: "
        + ("not run)" if fp32_peak is None else
           f"{fp32_peak / 2**20:.1f} MiB)"))

    # (d) where one bf16 DSM step's time goes
    rec["profile"] = trace(step)
    log_trace(f"one bf16 DSM step at batch {SGM_BATCH}", rec["profile"])

    # (e) the no-grad request: EM with one corrector step, the production
    # preset's knobs, reduced to batch 16 and 4 steps
    sw, sample = bf16_request(gen, dev)
    state0 = g.get_state()
    common.reset_launches()
    r = timed_call(sample, g)
    xs = r["out"]
    got = check_bf16_request(r)
    rec["request"] = dict(ms=r["ms"], peak=r["peak"], launches=got)
    log(f"{card}: bf16 request of {DSM_BF16_REQUEST} samples x "
        f"{DSM_BF16_STEPS} EM steps + {sw.corrector_steps} corrector step: "
        f"{r['ms']:.1f} ms, launches {got}")
    rec["request_profile"] = trace(lambda: sample(g))
    log_trace(f"the bf16 request ({DSM_BF16_REQUEST} x {DSM_BF16_STEPS} PC "
              "steps)", rec["request_profile"])

    def replay(fp32=False):
        replay_g = torch.Generator(device=dev)
        replay_g.set_state(state0)
        saved = {m: m.compute_dtype for m in model.modules()
                 if hasattr(m, "compute_dtype")}
        common.reset_launches()
        try:
            for m in saved:
                m.compute_dtype = torch.float32 if fp32 else saved[m]
            with plain_path():
                out = sample(replay_g)
        finally:
            for m, dt in saved.items():
                m.compute_dtype = dt
        if any(launch_counts().values()):
            raise AssertionError(f"plain replay launched {launch_counts()}")
        return out

    xp = replay()
    x32 = replay(fp32=True)
    rep = replay_errs(xs, xp, filter_blowups)
    own = replay_errs(xp, x32, filter_blowups)
    kf = replay_errs(xs, x32, filter_blowups)
    rec["request"].update(plain_replay=rep, bf16_against_fp32=own,
                          kernel_against_fp32=kf)
    replay_gates("the bf16 request", rep, own, kf, first_absolute=False)
    return rec


# phase 25: the grf16_production preset on the unfused route through the
# CLI: every AttentionBlock module by module, its core the bf16 K6 (no K3)
PROD_UNFUSED_ARGS = [*PROD_ARGS, "--attention-impl", "unfused"]


def check_production_unfused(g, dev, card):
    """Phase 25: ``sdeflow_tpu_torch.run.main`` on grf16_production with
    ``--attention-impl unfused``, with production_run's checks on the
    unfused route: per bf16 SSM step K5 46, K5b 46 and K6 11 (MSGM: K1 5,
    K2's solve 1), per request K5 92·32 and K6 22·32 (MSGM: K1 counted),
    no K3 and no float32 entry of an attention kernel."""
    rec = production_run(g, dev, card, PROD_UNFUSED_ARGS, "unfused",
                         replay=False)
    if rec["launches"]["fused_attention_block"]:
        raise AssertionError(f"the unfused run launched K3: "
                             f"{rec['launches']}")
    rec["request_profile"] = pc_request_profile(unfused_production(), g, dev)
    return rec


def k7_timing(g, dev, record):
    """--only k7: K7a and K7b as direct launches at the DSM path's shape
    (128, 4096, 64), K7a's lse sweep (recorded, not held), and bare DSM
    train steps of the SGM arm of _grf(128) at batch 128; to compare two
    trees of the package in one call."""
    from sdeflow_tpu_torch import Trainer
    from sdeflow_tpu_torch.ops.kernels import attention as ak
    from sdeflow_tpu_torch.ops.kernels import common

    b, t, c = SGM_BATCH, 4096, 64
    qkv = 1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)
    dout = torch.randn(b, t, c, generator=g, device=dev)
    with torch.no_grad():
        out, lse = ak._launch_stats(qkv, 1)
        delta = (ak._heads(dout, 1) * ak._heads(out, 1)).sum(-1)
        record["k7a_ms"] = [cuda_ms(lambda: ak._launch_stats(qkv, 1), 5, 1)
                            for _ in range(3)]
        record["k7b_ms"] = [cuda_ms(lambda: ak._launch_bwd(
            qkv, dout, lse, delta, 1), 3, 1) for _ in range(3)]
    log(f"K7a at {[b, t, c]}: {record['k7a_ms']} ms; K7b: "
        f"{record['k7b_ms']} ms")
    del qkv, dout, out, lse, delta
    record["lse_draws"] = lse_sweep(ak, dev, strict=False)
    tc, model, gen, sampler = sgm_arm(g, dev)
    trainer = Trainer(gen, sampler, lr=tc.lr, batch_size=SGM_BATCH,
                      loss="dsm")
    want = {k: SGM_WANT.get(k, 0) for k in common.KERNELS}

    def step():
        return trainer.train_step(trainer.state, g,
                                  sampler.sample(g, SGM_BATCH))[1]

    step()  # warm: cuDNN's choices, the allocator
    record["dsm"] = timed_train_steps(step, model, SGM_TIMED_STEPS, want,
                                      SGM_BATCH)


def attn_bf16_timing(g, dev, record):
    """--only attn_bf16: K6 bf16 at the DSM step's T = 1024 level
    (K6_BF16_DSM), K4 bf16 at K4_BF16_TIMED, and K7a and K7b bf16 at the
    DSM step's T = 4096 shape as direct launches, three runs each, beside
    SDPA in bf16 (forward; backward for K7b) and the bounds; then bare bf16
    DSM steps of the grf U-Net at 128x128, batch 128, with a trace and peak
    memory (K5b bf16 46 a step), and phase 24's request (batch 16, 4 EM
    steps and one corrector step) three times with a trace; then a traced
    bf16 SGM SSM step (batch 128) and a traced 2-step PC request (1,024
    samples) of grf16_production on the unfused route (K6 bf16's short
    path 11 a step and 22 a PC step). To compare two trees of the package
    in one call, copy this script into the other tree and run both in
    turns."""
    from sdeflow_tpu_torch import Trainer, build_sgm_arm
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops.kernels import attention as ak
    from sdeflow_tpu_torch.ops.kernels import common

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf = torch.bfloat16
    b, t, c = K6_BF16_DSM
    qkv = (1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)).to(bf)
    q, k, v = sdpa_args(qkv, 1)
    with torch.no_grad():
        record["k6"] = dict(
            shape=[b, t, c],
            direct_ms=[cuda_ms(lambda: ak._launch(qkv, 1), 20)
                       for _ in range(3)],
            library_ms=cuda_ms(lambda: sdpa(q, k, v), 20),
            bound_ms=bound_bf16_ms(*k6_bf16_cost(b, t, c, 1))[0])
    del qkv, q, k, v
    record["k4"] = []
    for b, t, c in K4_BF16_TIMED:
        qkv = (1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)).to(bf)
        q, k, v = sdpa_args(qkv, 1)
        with torch.no_grad():
            record["k4"].append(dict(
                shape=[b, t, c],
                direct_ms=[cuda_ms(lambda: ak._launch(qkv, 1), 50)
                           for _ in range(3)],
                library_ms=cuda_ms(lambda: sdpa(q, k, v), 50),
                bound_ms=bound_bf16_ms(*k6_bf16_cost(b, t, c, 1))[0]))
        del qkv, q, k, v
    b, t, c = ATTN_BF16_LONG[1]
    qkv = (1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)).to(bf)
    dout = torch.randn(b, t, c, generator=g, device=dev).to(bf)
    q, k, v = (a.requires_grad_() for a in sdpa_args(qkv, 1))
    o = sdpa(q, k, v)
    do = ak._heads(dout, 1).contiguous()
    with torch.no_grad():
        out, lse = ak._launch_stats(qkv, 1)
        delta = (ak._heads(dout, 1).float()
                 * ak._heads(out, 1).float()).sum(-1)
        record["k7a"] = dict(
            shape=[b, t, c],
            direct_ms=[cuda_ms(lambda: ak._launch_stats(qkv, 1), 5, 1)
                       for _ in range(3)],
            library_ms=cuda_ms(lambda: sdpa(q, k, v), 5, 1),
            bound_ms=bound_bf16_ms(*k7a_bf16_cost(b, t, c, 1))[0])
        record["k7b"] = dict(
            shape=[b, t, c],
            direct_ms=[cuda_ms(lambda: ak._launch_bwd(
                qkv, dout, lse, delta, 1), 3, 1) for _ in range(3)],
            bound_ms=bound_bf16_ms(*k7b_bf16_cost(b, t, c, 1))[0])
    record["k7b"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        o, (q, k, v), do, retain_graph=True), 3, 1)
    for key, r in [("k6", record["k6"]), *(("k4", r) for r in record["k4"]),
                   ("k7a", record["k7a"]), ("k7b", record["k7b"])]:
        log(f"bf16 {key.upper()} at {r['shape']}: direct "
            f"{[round(x, 4) for x in r['direct_ms']]} ms, SDPA bf16 "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms")
    del qkv, dout, q, k, v, o, do, out, lse, delta

    _, model, gen, sampler = bf16_dsm_arm(g, dev)
    trainer = Trainer(gen, sampler, lr=1e-4, batch_size=SGM_BATCH,
                      loss="dsm")
    want = {k: SGM_WANT.get(k, 0) for k in common.KERNELS}

    def step():
        return trainer.train_step(trainer.state, g,
                                  sampler.sample(g, SGM_BATCH))[1]

    step()  # warm: cuDNN's choices, the allocator
    record["dsm_bf16"] = timed_train_steps(step, model, SGM_TIMED_STEPS,
                                           want, SGM_BATCH)
    record["dsm_bf16"]["profile"] = trace(step)
    log_trace(f"one bf16 DSM step at batch {SGM_BATCH}",
              record["dsm_bf16"]["profile"])

    # phase 24's request on the same net (its weights as the steps left
    # them): one warm run, three timed, one traced
    sw, sample = bf16_request(gen, dev)
    sample(g)
    runs = [timed_call(sample, g) for _ in range(3)]
    for r in runs:
        check_bf16_request(r)
    record["request"] = dict(ms=[r["ms"] for r in runs],
                             profile=trace(lambda: sample(g)))
    log(f"bf16 request of {DSM_BF16_REQUEST} samples x {DSM_BF16_STEPS} EM "
        f"steps + {sw.corrector_steps} corrector step: "
        f"{[round(r['ms'], 1) for r in runs]} ms")
    log_trace("the bf16 request", record["request"]["profile"])

    # grf16_production on the unfused route: a traced bf16 SSM step and a
    # traced 2-step PC request
    del model, gen, sampler, trainer, sw, sample
    torch.cuda.empty_cache()
    cfg = unfused_production()
    model, gen = build_sgm_arm(cfg, None, device=dev)
    randomize_(model, g)
    with torch.no_grad():
        model.core.conv_out.weight.mul_(0.1)
    sampler = drv.make_sampler(cfg, DIM, device=dev)
    trainer = drv.make_trainer(cfg, gen, sampler, TRAIN_BATCH, log_fn=log)
    record["ssm_unfused_profile"] = trace(lambda: trainer.train_step(
        trainer.state, g, sampler.sample(g, TRAIN_BATCH)))
    log_trace(f"one bf16 SGM SSM step at batch {TRAIN_BATCH}, unfused route",
              record["ssm_unfused_profile"])
    del model, gen, sampler, trainer
    record["request_unfused_profile"] = pc_request_profile(cfg, g, dev)


def bf16_unfused_phases(card, fp32_peak=None):
    """Phases 23-25 as (label, record key, fn(g, dev))."""
    return [("23", "attention_bf16", check_attention_bf16),
            ("24", "dsm_bf16", lambda g, dev: check_dsm_bf16(
                g, dev, card, fp32_peak)),
            ("25", "production_unfused", lambda g, dev:
             check_production_unfused(g, dev, card))]


# phase 26: the PF-ODE and DPM-Solver samplers and the exact NLL through
# the CLI on grf16 at full width, reduced as phase 20 is
SAMPLER_ARGS = ["--preset", "grf16", "--iterations", str(DRIVER_ITERATIONS),
                "--num-samples", str(N_SAMPLES), "--no-plots"]
ODE_ARGS = [*SAMPLER_ARGS, "--steps-backward", str(STEPS), "--sampler",
            "ode", "--eval-mmd", "--eval-nll"]
DPM_STEPS = 16
DPM_ARGS = [*SAMPLER_ARGS, "--steps-backward", str(DPM_STEPS), "--sampler",
            "dpm", "--backward-method", "dpm2m"]
NLL_POINTS, NLL_STEPS = 512, 64  # nll_summary's max_points, grf16's steps
# the NLL's kernel-against-plain check: the driver's NLL_POINTS test points
# and probes, at the batch the main path gives the kernels, on 8 RK4 steps
# (a JVP stage takes ~0.15 s of host time: 64 steps would cost 40 s a path)
NLL_CHECK_STEPS = 8
DOPRI_SAMPLES = 256
# the ODE's kernel path against its plain replay, as the SDE's (PERF.md
# §2): max |kernel − plain| ≤ 1e-3·max |x|. The NLL is the same
# deterministic solve's output (its latent's prior plus its divergence
# integral, the tangents by the same plain rules on both paths), held by
# the same rule: max |Δ bits/dim| ≤ 1e-3·max |bits/dim|
ODE_REPLAY_TOL = NLL_REPLAY_TOL = 1e-3
# the kernels of phase 26's ODE run: each must launch (K5b in its training)
SAMPLER_KERNELS = ("circulant_apply", "fused_attention_block",
                   "group_norm_silu", "group_norm_silu_bwd")


def drift_want(is_msgm, evals):
    """Launches of `evals` evaluations of a PF-ODE drift (or its JVP) on the
    auto route: the U-Net's K3 and K5, and on MSGM one sigma_apply (K1) an
    evaluation; the tangents run the plain rules."""
    want = {k: n * evals for k, n in per_forward("auto").items()}
    return dict(want, circulant_apply=evals if is_msgm else 0,
                circulant_rk4_step=0, circulant_rk4_solve=0)


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def sampler_cli(args, gens, nlls):
    """``sdeflow_tpu_torch.run.main(args)`` in a temporary cwd and results
    directory, every kernel count set to 0 just before and read just after,
    each generation and NLL call recorded (timed_call), the output kept;
    returns (results, launches, seconds, output)."""
    import tempfile

    from sdeflow_tpu_torch import run as run_mod
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops.kernels import common

    cwd = os.getcwd()
    tee = _Tee(sys.stdout)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with spied(drv, "generate", gens), \
                    spied(drv, "nll_summary", nlls), \
                    contextlib.redirect_stdout(tee):
                common.reset_launches()
                t0 = time.perf_counter()
                results = run_mod.main(
                    [*args, "--results-dir", os.path.join(tmp, "results")])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = launch_counts()
        finally:
            os.chdir(cwd)
    return results, launches, seconds, "".join(tee.parts)


def replayed(rec, fn, *args, **kwargs):
    """fn on rec's arguments with its generator argument put back in the
    state it had before rec's call (the same latents and probes), on the
    plain path: (out, launches, ms)."""
    from sdeflow_tpu_torch.ops.kernels import common

    call = list(rec["args"])
    i = next(i for i, a in enumerate(call) if isinstance(a, torch.Generator))
    g = torch.Generator(device=call[i].device)
    g.set_state(rec["generator_states"][0])
    call[i] = g
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_path():
        out = fn(*call, *args, **{**rec["kwargs"], **kwargs})
    torch.cuda.synchronize()
    return out, launch_counts(), (time.perf_counter() - t0) * 1e3


def check_samplers(g, dev, card, sde_request_ms=None):
    """Phase 26: ``run.main`` with --sampler ode (RK4-32, --eval-mmd,
    --eval-nll) and with --sampler dpm (dpm2m on 16 steps; the MSGM arm's
    logged fallback), both arms, their launches, finiteness, norms and
    times; each ODE request and NLL replayed on the plain path; then a
    dopri solve of DOPRI_SAMPLES samples on each trained arm."""
    import numpy as np

    from sdeflow_tpu_torch.eval.nll import nll_bits_per_dim
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops.hutchinson import sample_v
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.ode import integrate_ode

    rec = {"card": card, "ode_args": ODE_ARGS, "dpm_args": DPM_ARGS}
    arms = (("SGM", False), ("MSGM", True))

    # (a) the PF-ODE: sampling, metrics and the NLL, both arms
    gens, nlls = [], []
    results, launches, seconds, _ = sampler_cli(ODE_ARGS, gens, nlls)
    rec["ode_run"] = dict(seconds=seconds, launches=launches)
    log(f"{card}: --sampler ode --eval-mmd --eval-nll: {seconds:.1f} s, "
        f"launches {launches}")
    missing = [k for k in SAMPLER_KERNELS if not launches[k]]
    if missing or len(gens) != 2 or len(nlls) != 2:
        raise AssertionError(f"the ODE run: never launched {missing}; "
                             f"{len(gens)} generations, {len(nlls)} NLLs")
    rec["ode"], rec["nll"] = {}, {}
    for (arm, is_msgm), r, n in zip(arms, gens, nlls):
        xs = r["out"]
        if tuple(xs.shape) != (STEPS + 1, N_SAMPLES, DIM) or \
                not torch.isfinite(xs).all():
            raise AssertionError(f"{arm}: ODE trajectory {tuple(xs.shape)}")
        want = drift_want(is_msgm, FORWARDS_PER_STEP * STEPS)
        if r["launches"] != want:
            raise AssertionError(f"{arm} ODE launches {r['launches']} != "
                                 f"{want}")
        norms = xs.norm(dim=2)
        kept = bool(torch.allclose(norms, norms[0].expand_as(norms),
                                   rtol=1e-5, atol=0))
        if kept is not is_msgm:
            raise AssertionError(f"{arm}: ODE norms kept = {kept}")
        xp, plain_k, plain_ms = replayed(r, drv.generate)
        if any(plain_k.values()):
            raise AssertionError(f"plain ODE replay launched {plain_k}")
        err = (xs - xp).abs().max().item()
        big = xp.abs().max().item()
        rec["ode"][arm] = dict(
            ms=r["ms"], event_ms=r["event_ms"],
            samples_per_s=N_SAMPLES / r["ms"] * 1e3,
            launches=r["launches"], peak=r["peak"], norms_kept=kept,
            plain_ms=plain_ms, max_abs_err=err, max_abs_x=big)
        log(f"{card}: {arm} ODE request, {N_SAMPLES} samples x {STEPS} RK4 "
            f"steps (trajectory kept): {r['ms']:.1f} ms (CUDA events "
            f"{r['event_ms']:.1f}), {N_SAMPLES / r['ms'] * 1e3:.1f} "
            f"samples/s (plain path "
            f"{plain_ms:.1f} ms), launches {r['launches']}, norms kept "
            f"{kept}; max |kernel - plain| {err:.3g} against max |x| "
            f"{big:.3g} (tolerance {ODE_REPLAY_TOL:g}·max |x|)")
        if not err <= ODE_REPLAY_TOL * big:
            raise AssertionError(f"{arm}: ODE kernel and plain disagree")

        # the NLL: all NLL_POINTS finite, its launches, and a replay of
        # the same points with the driver's own probes
        entry = n["out"]
        want = drift_want(is_msgm, FORWARDS_PER_STEP * NLL_STEPS)
        if entry["n"] != NLL_POINTS or entry["steps"] != NLL_STEPS or \
                not math.isfinite(entry["mean"]):
            raise AssertionError(f"{arm}: NLL {entry}")
        if n["launches"] != want:
            raise AssertionError(f"{arm} NLL launches {n['launches']} != "
                                 f"{want}")
        gen, xtest, _ = n["args"]
        probe_g = torch.Generator(device=dev)
        probe_g.set_state(n["generator_states"][0])
        probes = sample_v(probe_g, (1, NLL_POINTS, DIM), "rademacher",
                          device=dev)
        x = xtest[:NLL_POINTS]
        with torch.no_grad():
            common.reset_launches()
            kernel = timed_call(nll_bits_per_dim, gen, x, probes=probes,
                                num_steps=NLL_CHECK_STEPS)
            with plain_path():
                plain = timed_call(nll_bits_per_dim, gen, x, probes=probes,
                                   num_steps=NLL_CHECK_STEPS)
        if any(plain["launches"].values()):
            raise AssertionError(f"plain NLL launched {plain['launches']}")
        want = drift_want(is_msgm, FORWARDS_PER_STEP * NLL_CHECK_STEPS)
        if kernel["launches"] != want:
            raise AssertionError(f"{arm} NLL check launches "
                                 f"{kernel['launches']} != {want}")
        bk, bp = kernel["out"], plain["out"]
        if not (torch.isfinite(bk).all() and torch.isfinite(bp).all()):
            raise AssertionError(f"{arm}: NLL not finite")
        err = (bk - bp).abs().max().item()
        big = bp.abs().max().item()
        rec["nll"][arm] = dict(
            entry=entry, s=n["ms"] / 1e3, event_s=n["event_ms"] / 1e3,
            launches=n["launches"],
            launches_per_stage=drift_want(is_msgm, 1),
            check_points=NLL_POINTS, check_steps=NLL_CHECK_STEPS,
            check_ms=kernel["ms"],
            check_plain_ms=plain["ms"], max_abs_err=err, max_abs_bpd=big)
        log(f"{card}: {arm} NLL {entry['mean']:.4f} ± {entry['stderr']:.4f} "
            f"bits/dim on {entry['n']} points, {NLL_STEPS} RK4 steps: "
            f"{n['ms'] / 1e3:.2f} s, launches {n['launches']} (a stage: "
            f"{drift_want(is_msgm, 1)}); {NLL_POINTS} points, "
            f"{NLL_CHECK_STEPS} steps: kernel {kernel['ms']:.1f} ms, plain "
            f"{plain['ms']:.1f} ms, max |Δ| "
            f"{err:.3g} bits/dim against max {big:.3g} (tolerance "
            f"{NLL_REPLAY_TOL:g}·max)")
        if not err <= NLL_REPLAY_TOL * big:
            raise AssertionError(f"{arm}: NLL kernel and plain disagree")
    for k in drv.METRICS:
        if not np.isfinite(results[k]).all():
            raise AssertionError(f"results[{k!r}] = {results[k]}")
    rec["sqrt_mmd"] = {k: float(np.sqrt(max(results[k].mean(), 0.0)))
                       for k in ("mmd_sgm", "mmd_msgm", "mmd_ref")}
    log(f"ODE sqrt-MMD: {rec['sqrt_mmd']}")
    trained = [r["args"][0] for r in gens]

    # the SDE request of the same trained MSGM arm, for comparison
    r = gens[1]
    sde = timed_call(drv.generate, trained[1], torch.Generator(
        device=dev).manual_seed(1), N_SAMPLES, DIM, STEPS, "rk4", True,
        True, sampler="sde", device=dev)
    rec["msgm_sde_request_ms"] = sde["ms"]
    rec["msgm_sde_request_event_ms"] = sde["event_ms"]
    log(f"{card}: MSGM SDE request (RK4-{STEPS}, trajectory kept) on the "
        f"same trained arm: {sde['ms']:.1f} ms against the ODE's "
        f"{r['ms']:.1f} ms" + ("" if sde_request_ms is None else
                                f"; phase 7's request {sde_request_ms:.1f}"
                                " ms"))

    # (b) DPM-Solver: dpm2m on the SGM arm, MSGM's logged fallback
    gens_dpm = []
    _, launches, seconds, out = sampler_cli(DPM_ARGS, gens_dpm, [])
    rec["dpm_run"] = dict(seconds=seconds, launches=launches)
    fallback = ("sampler 'dpm' needs a closed-form forward kernel; "
                "MSGM_sparseTenslogNorm arm falls back to sampler 'sde' / "
                "method 'rk4'")
    if out.count(fallback) != 1:
        raise AssertionError("the MSGM arm's dpm fallback was not logged")
    rec["dpm"] = {}
    for (arm, is_msgm), r in zip(arms, gens_dpm):
        xs = r["out"]
        method = r["args"][5]
        if is_msgm:  # the fallback: the SDE's RK4, 8 K1 a step
            want = {k: n * FORWARDS_PER_STEP * DPM_STEPS for k, n in
                    per_forward("auto").items()}
            want.update(circulant_apply=K1_PER_STEP * DPM_STEPS,
                        circulant_rk4_step=0, circulant_rk4_solve=0)
        else:
            want = drift_want(False, DPM_STEPS)
        if (method, r["kwargs"]["sampler"]) != (
                ("rk4", "sde") if is_msgm else ("dpm2m", "dpm")):
            raise AssertionError(f"{arm}: {method}, {r['kwargs']}")
        if tuple(xs.shape) != (DPM_STEPS + 1, N_SAMPLES, DIM) or \
                not torch.isfinite(xs).all() or r["launches"] != want:
            raise AssertionError(f"{arm} dpm run: {tuple(xs.shape)}, "
                                 f"launches {r['launches']} != {want}")
        rec["dpm"][arm] = dict(method=method, ms=r["ms"],
                               event_ms=r["event_ms"],
                               samples_per_s=N_SAMPLES / r["ms"] * 1e3,
                               launches=r["launches"])
        log(f"{card}: {arm} --sampler dpm request ({method}, {DPM_STEPS} "
            f"steps, trajectory kept): {r['ms']:.1f} ms, launches "
            f"{r['launches']}")

    # (c) an adaptive dopri solve on each trained arm of (a)
    rec["dopri"] = {}
    for (arm, is_msgm), gen in zip(arms, trained):
        x0 = gen.latent_sample(torch.Generator(device=dev).manual_seed(2),
                               DOPRI_SAMPLES, DIM)
        stats = {}
        with torch.no_grad():
            common.reset_launches()
            r = timed_call(integrate_ode, gen, x0, 1, method="dopri",
                           norm_correction=is_msgm, stats=stats)
        x = r["out"]
        if not torch.isfinite(x).all():
            raise AssertionError(f"{arm}: dopri samples not finite")
        if is_msgm:
            torch.testing.assert_close(x.norm(dim=1), x0.norm(dim=1),
                                       rtol=1e-5, atol=0)
        if r["launches"] != drift_want(is_msgm, stats["nfe"]):
            raise AssertionError(f"{arm} dopri launches {r['launches']} "
                                 f"for {stats}")
        rec["dopri"][arm] = dict(stats, ms=r["ms"], event_ms=r["event_ms"],
                                 samples=DOPRI_SAMPLES)
        log(f"{card}: {arm} dopri (rtol = atol = 1e-5) of {DOPRI_SAMPLES} "
            f"samples: {r['ms']:.1f} ms, NFE {stats['nfe']}, "
            f"{stats['accepted']} steps accepted, {stats['rejected']} "
            f"rejected")
    rec["launches"] = {k: rec["ode_run"]["launches"][k]
                       + rec["dpm_run"]["launches"][k]
                       for k in rec["ode_run"]["launches"]}
    return rec


# phase 27: the core MLP path and the DiT score nets. (a) grf16_dit through
# the CLI at phase 20's reduction (fp32, RK4-32), (b) grf16_production_dit
# at phase 22's (bf16, EMA 0.999, eps on SGM, EM-32 plus one corrector
# step); the DiT reaches no kernel, so the MSGM arm's K1 and K2's solve are
# the path's only launches
DIT_ARGS = ["--preset", "grf16_dit", "--iterations", str(DRIVER_ITERATIONS),
            "--num-samples", str(N_SAMPLES), "--steps-backward", str(STEPS),
            "--eval-mmd", "--no-plots"]
DIT_PROD_ARGS = ["--preset", "grf16_production_dit", "--iterations",
                 str(DRIVER_ITERATIONS), "--num-samples", str(N_SAMPLES),
                 "--eval-mmd", "--no-plots"]
DIT_KERNELS = ("circulant_apply", "circulant_rk4_solve")
# K1 per step of a request: RK4 8 (four stages, the drift's g·a and the
# noise each), a PC step 4 (EM's drift and noise, the corrector's)
DIT_K1_PER_RK4, DIT_K1_PER_PC = K1_PER_STEP, 4
# (c) the JAX package's end-to-end runs (tests/test_train_e2e.py:29-89):
# swissroll SGM, MLP, 3,000 steps at batch 256, EM-100 on 4,000 samples,
# √MMD < 0.15; MSGM on GaussianCauchy with a dense G, 300 steps at batch
# 64, 8 forward steps, RK4-32 norm-corrected on 512 samples
E2E_STEPS, E2E_BATCH, E2E_EM, E2E_N, E2E_SQRT_MMD = 3000, 256, 100, 4000, 0.15
GC_STEPS, GC_BATCH, GC_FORWARD, GC_RK4, GC_N = 300, 64, 8, 32, 512
# the CLI on the toy presets, reduced to a few hundred iterations
CORE_CLI_PRESETS, CORE_CLI_ITERATIONS = ("swissroll", "gaussian",
                                         "cauchy"), 300


def dit_step_want(is_msgm):
    """Launches per bare SSM step of a DiT arm: MSGM's forward solve (K2's
    solve) and its K1 (the one-step fallback's four, the loss field's
    one); nothing on SGM."""
    want = {k: 0 for k in launch_counts()}
    if is_msgm:
        want.update(circulant_apply=K1_PER_TRAIN,
                    circulant_rk4_solve=K2_SOLVE_PER_TRAIN)
    return want


def msgm_cli_run(g, dev, card, args, bf16, net_type="DiT2D", dim=DIM):
    """``sdeflow_tpu_torch.run.main`` with args (a preset whose score net,
    of type net_type at width dim, reaches no kernel: grf16_dit,
    grf16_production_dit, lorenz63_unet1d, lorenz63_dit) in a temporary
    cwd and results directory, every kernel count set to 0 just before and
    read just after: each arm's bare SSM steps with their launches
    (dit_step_want), finite losses, moving parameters (bf16: the net
    computing in bf16, parameters, Adam moments and EMA fp32), each arm's
    request with its K1 launches and norms (bf16: the corrector's step
    sizes), the MSGM request replayed on the plain path (fp32: within
    1e-3·max |x|; bf16: phase 22's gates), and the metrics."""
    import tempfile

    import numpy as np

    from sdeflow_tpu_torch import run as run_mod
    from sdeflow_tpu_torch.eval.diagnostics import filter_blowups
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops import integrators
    from sdeflow_tpu_torch.ops.kernels import common

    rec = {"card": card, "args": args}
    steps, gens, scores, corr = [], [], [], []
    orig_corrector = integrators.langevin_corrector

    def corrector(*a, **k):
        out = orig_corrector(*a, **k)
        corr.append(out[1])
        return out

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with counted_steps(steps), spied(drv, "generate", gens), \
                    spied(drv, "postprocessing", scores), \
                    swapped([(integrators, "langevin_corrector",
                              corrector)]):
                common.reset_launches()
                t0 = time.perf_counter()
                results = run_mod.main(
                    [*args, "--results-dir", os.path.join(tmp, "results")])
                torch.cuda.synchronize()
                rec["driver_s"] = time.perf_counter() - t0
                rec["launches"] = launch_counts()
        finally:
            os.chdir(cwd)
    what = args[args.index("--preset") + 1]
    log(f"{what} run: {rec['driver_s']:.1f} s, launches {rec['launches']}")
    others = {k: n for k, n in rec["launches"].items()
              if n and k not in DIT_KERNELS}
    missing = [k for k in DIT_KERNELS if not rec["launches"][k]]
    if missing or others:
        raise AssertionError(f"{what}: never launched {missing}; launched "
                             f"{others} (the {net_type} reaches no kernel)")

    # training: both arms, their bare steps and launches
    arms = {"SGM": "SGM", "MSGM": "MSGM_sparseTenslogNorm"}
    rec["train"] = {}
    for arm, sde_name in arms.items():
        mine = [r for r in steps if r["arm"] == sde_name]
        want = dit_step_want(arm == "MSGM")
        if len(mine) != DRIVER_ITERATIONS:
            raise AssertionError(f"{arm}: {len(mine)} train steps")
        bad = [r["launches"] for r in mine if r["launches"] != want]
        if bad:
            raise AssertionError(f"{arm} step launches {bad[0]} != {want}")
        losses = torch.stack([r["loss"] for r in mine])
        state, opt = mine[-1]["state"], mine[-1]["optimizer"]
        moved = max((p.detach() - q).abs().max().item() for p, q in zip(
            state.params.values(), mine[0]["params_before"]))
        net = state.gen_sde.score_net
        dtypes = {str(t.dtype) for t in (
            *state.params.values(),
            *(state.ema_params.values() if bf16 else ()),
            *(v for st in opt.state.values() for v in st.values()
              if isinstance(v, torch.Tensor) and v.ndim))}
        want_dt = torch.bfloat16 if bf16 else torch.float32
        if not (torch.isfinite(losses).all() and moved > 0
                and dtypes == {"torch.float32"}
                and type(net).__name__ == net_type
                and net.compute_dtype == want_dt):
            raise AssertionError(f"{arm}: losses {losses}, moved {moved}, "
                                 f"dtypes {dtypes}, net {type(net)}")
        ms = [r["ms"] for r in mine]
        rec["train"][arm] = dict(
            ms_per_step=ms, ms_per_step_after_first=sum(ms[1:]) / len(ms[1:]),
            max_memory_allocated=max(r["peak"] for r in mine),
            launches_per_step=mine[-1]["launches"], losses=losses.tolist(),
            param_moved=moved, state_dtypes=sorted(dtypes))
        log(f"{card}: {what} {arm} bare SSM steps at batch "
            f"{mine[-1]['args'][2].shape[0]}: "
            f"{rec['train'][arm]['ms_per_step_after_first']:.1f} ms/step "
            f"(steps 2-{DRIVER_ITERATIONS}; the first {ms[0]:.1f} ms), peak "
            f"{rec['train'][arm]['max_memory_allocated'] / 2**20:.1f} MiB, "
            f"launches {dict((k, v) for k, v in want.items() if v)}")

    # generation: one request per arm
    n_steps = PROD_STEPS if bf16 else STEPS
    k1_per = DIT_K1_PER_PC if bf16 else DIT_K1_PER_RK4
    if len(gens) != 2 or (bf16 and len(corr) != 2 * PROD_STEPS):
        raise AssertionError(f"{len(gens)} generation runs, {len(corr)} "
                             "corrector calls")
    rec["generate"] = {}
    for i, ((arm, is_msgm), r) in enumerate(zip(
            (("SGM", False), ("MSGM", True)), gens)):
        xs = r["out"]
        if tuple(xs.shape) != (n_steps + 1, N_SAMPLES, dim) or \
                not torch.isfinite(xs).all():
            raise AssertionError(f"{arm}: trajectory {tuple(xs.shape)}")
        want = dict(dit_step_want(False),
                    circulant_apply=k1_per * n_steps if is_msgm else 0)
        if r["launches"] != want:
            raise AssertionError(f"{arm} request launches {r['launches']} "
                                 f"!= {want}")
        norms = xs.norm(dim=2)
        kept = bool(torch.allclose(norms, norms[0].expand_as(norms),
                                   rtol=1e-5, atol=0))
        if kept is not is_msgm:
            raise AssertionError(f"{arm}: norms kept = {kept}")
        out = dict(ms=r["ms"], event_ms=r["event_ms"],
                   samples_per_s=N_SAMPLES / r["ms"] * 1e3,
                   launches=r["launches"], peak=r["peak"], norms_kept=kept)
        if bf16:
            eps = torch.cat(corr[i * PROD_STEPS:(i + 1) * PROD_STEPS]).tolist()
            stepped = sum(e > 0 for e in eps)
            if not (stepped and all(math.isfinite(e) for e in eps)):
                raise AssertionError(f"{arm}: corrector step sizes {eps}")
            out.update(corrector_eps=eps, corrector_steps_taken=stepped)
        rec["generate"][arm] = out
        log(f"{card}: {what} {arm} request of {N_SAMPLES} samples x "
            f"{n_steps} {'EM + 1 corrector' if bf16 else 'RK4'} steps "
            f"(trajectory kept): {r['ms']:.1f} ms (CUDA events "
            f"{r['event_ms']:.1f}), {out['samples_per_s']:.1f} samples/s, "
            f"peak {r['peak'] / 2**20:.1f} MiB, K1 "
            f"{r['launches']['circulant_apply']}, norms kept {kept}")

    # the MSGM request replayed on the plain path (K1's plain version)
    r = gens[1]

    def rerun(fp32=False):
        net = r["args"][0].score_net
        saved = {m: m.compute_dtype for m in net.modules()
                 if hasattr(m, "compute_dtype")}
        try:
            for m in saved:
                m.compute_dtype = torch.float32 if fp32 else saved[m]
            out, launches, ms = replayed(r, drv.generate)
        finally:
            for m, dt in saved.items():
                m.compute_dtype = dt
        if any(launches.values()):
            raise AssertionError(f"plain replay launched {launches}")
        return out, ms

    xp, plain_ms = rerun()
    rep = replay_errs(r["out"], xp, filter_blowups)
    rec["generate"]["MSGM"].update(plain_replay=rep, plain_ms=plain_ms)
    if bf16:
        x32, _ = rerun(fp32=True)
        own = replay_errs(xp, x32, filter_blowups)
        kf = replay_errs(r["out"], x32, filter_blowups)
        rec["generate"]["MSGM"].update(bf16_against_fp32=own,
                                       kernel_against_fp32=kf)
        replay_gates(f"MSGM {what} request", rep, own, kf)
    else:
        log(f"MSGM {what} request replayed plain ({plain_ms:.1f} ms): max "
            f"|kernel - plain| {rep['max_abs_err_all']:.3g} against max |x| "
            f"{rep['max_abs_x']:.3g} (tolerance 1e-3·max |x|)")
        if not rep["max_abs_err_all"] <= 1e-3 * rep["max_abs_x"]:
            raise AssertionError(f"{what}: kernel and plain disagree")

    # the metrics
    for k in drv.METRICS:
        if results[k].shape != (1, 1, 1, 1, 1) or \
                not np.isfinite(results[k]).all():
            raise AssertionError(f"results[{k!r}] = {results[k]}")
    rec["metrics"] = {}
    for arm, c in zip(("SGM", "MSGM"), scores):
        o = c["out"]
        rec["metrics"][arm] = dict(sqrt_mmd=o["mmd"] ** 0.5, swd=o["swd"],
                                   sqrt_mmd_floor=o["mmd_ref"] ** 0.5,
                                   nan_count=o["nan_count"])
        log(f"{card}: {what} {arm}: sqrt-MMD {o['mmd'] ** 0.5:.5f}, SWD "
            f"{o['swd']:.5f} (floor {o['mmd_ref'] ** 0.5:.5f}, "
            f"{o['nan_count']} rows dropped)")
    return rec


def dit_traces(preset, g, dev, dim=DIM, randomize=True):
    """Where an MSGM arm's time goes (random weights): a traced bare SSM
    step at the preset's batch (the driver's Trainer) and a traced 2-step
    request of 1,024 samples with the preset's sampler."""
    from sdeflow_tpu_torch import build_msgm_arm, get_preset, make_sampler_fn
    from sdeflow_tpu_torch.experiments import driver as drv

    cfg = get_preset(preset)
    sw = cfg.sweep
    batch = sw.batch_sizes[0]
    model, gen = build_msgm_arm(cfg, g, device=dev)
    if randomize:
        randomize_(model, g)
    sampler = drv.make_sampler(drv.arm_config(cfg, True), dim, device=dev)
    trainer = drv.make_trainer(cfg, gen, sampler, batch, log_fn=log)
    rec = {"ssm_step": trace(lambda: trainer.train_step(
        trainer.state, g, sampler.sample(g, batch)))}
    log_trace(f"one {preset} MSGM SSM step at batch {batch}",
              rec["ssm_step"])
    fn = make_sampler_fn(gen, N_SAMPLES, dim, PROFILED_STEPS,
                         method=sw.backward_method, norm_correction=True,
                         corrector_steps=sw.corrector_steps, snr=sw.snr,
                         device=dev)
    rec["request"] = dict(trace(lambda: fn(g)), steps=PROFILED_STEPS)
    log_trace(f"{PROFILED_STEPS} {sw.backward_method} steps of a {preset} "
              f"MSGM request of {N_SAMPLES} samples", rec["request"])
    return rec


def core_path(g, dev, card):
    """(c) The core MLP path: the JAX package's swissroll SGM run and its
    MSGM GaussianCauchy run with a dense G through the Trainer, and the CLI
    on swissroll, gaussian (d = 2 … 32) and cauchy; none launches a kernel
    (K1 and K2 never see a dense G)."""
    import numpy as np

    from sdeflow_tpu_torch.data import GaussianCauchy, SwissRoll
    from sdeflow_tpu_torch.eval import compute_mmd
    from sdeflow_tpu_torch.models import MLP
    from sdeflow_tpu_torch.ops.integrators import integrate_sde
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.rng import fold_in
    from sdeflow_tpu_torch.sde import MSGMSde, PluginReverseSDE, SGMSde
    from sdeflow_tpu_torch.training import Trainer

    rec = {}

    def no_launch(what):
        if any(launch_counts().values()):
            raise AssertionError(f"{what} launched {launch_counts()}")

    def timed_run(trainer, gen_, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.run(gen_, steps)
        torch.cuda.synchronize()
        return state, loss, (time.perf_counter() - t0) * 1e3 / steps

    # swissroll SGM: the JAX e2e budget and gate
    common.reset_launches()
    sampler = SwissRoll(device=dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = MLP(input_dim=2).to(dev)
    gen = PluginReverseSDE.create(SGMSde.create(num_steps_forward=16,
                                                device=dev), net)
    trainer = Trainer(gen, sampler, lr=1e-3, batch_size=E2E_BATCH,
                      print_every=10_000, log_fn=log)
    state, loss, ms = timed_run(trainer, fold_in(g, 1), E2E_STEPS)
    with torch.no_grad():
        x0 = state.gen_sde.latent_sample(fold_in(g, 2), E2E_N, 2)
        t0 = time.perf_counter()
        xgen = integrate_sde(state.gen_sde, x0, fold_in(g, 3), E2E_EM,
                             method="em")
        torch.cuda.synchronize()
        em_ms = (time.perf_counter() - t0) * 1e3
    xtest = sampler.sampletest(fold_in(g, 4), E2E_N)
    xtrain = sampler.sample(fold_in(g, 5), E2E_N)
    sq = float(compute_mmd(xgen, xtest)) ** 0.5
    floor = float(compute_mmd(xtrain, xtest)) ** 0.5
    no_launch("the swissroll SGM run")
    first = trainer.history[0]["loss"]
    rec["swissroll_sgm"] = dict(ms_per_step=ms, em_ms=em_ms, sqrt_mmd=sq,
                                sqrt_mmd_floor=floor, first_loss=first,
                                last_loss=loss)
    log(f"{card}: swissroll SGM (MLP) {E2E_STEPS} steps at batch "
        f"{E2E_BATCH}: {ms:.2f} ms/step, loss {first:.3f} -> {loss:.3f}; "
        f"EM-{E2E_EM} of {E2E_N} samples {em_ms:.1f} ms; sqrt-MMD {sq:.4f} "
        f"(gate < {E2E_SQRT_MMD}), floor {floor:.4f}")
    if not (np.isfinite(sq) and sq < E2E_SQRT_MMD
            and (first > loss + 1.0 or loss < 2.0)):
        raise AssertionError(f"swissroll SGM: sqrt-MMD {sq}, loss {first} "
                             f"-> {loss}")

    # MSGM on GaussianCauchy with a dense G
    common.reset_launches()
    sampler = GaussianCauchy(fold_in(g, 10), dim=2)
    x_init = sampler.sample(fold_in(g, 11), 2048)
    sde = MSGMSde.create(x_init, generator=fold_in(g, 12), beta_max=2.0,
                         num_steps_forward=GC_FORWARD, norm_map="log")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        net = MLP(input_dim=2, premodule="NormalizeLogRadius").to(dev)
    trainer = Trainer(PluginReverseSDE.create(sde, net), sampler, lr=1e-3,
                      batch_size=GC_BATCH, print_every=10_000, log_fn=log)
    state, loss, ms = timed_run(trainer, fold_in(g, 13), GC_STEPS)
    with torch.no_grad():
        x0 = state.gen_sde.latent_sample(fold_in(g, 14), GC_N, 2)
        xgen = integrate_sde(state.gen_sde, x0, fold_in(g, 15), GC_RK4,
                             method="rk4", norm_correction=True)
    no_launch("the GaussianCauchy MSGM run")
    rel = ((xgen.norm(dim=1) - x0.norm(dim=1)).abs()
           / x0.norm(dim=1)).max().item()
    rec["gaussian_cauchy_msgm"] = dict(ms_per_step=ms, last_loss=loss,
                                       max_norm_rel_err=rel,
                                       G_shape=list(sde.G.shape))
    log(f"{card}: GaussianCauchy MSGM (dense G {tuple(sde.G.shape)}, MLP) "
        f"{GC_STEPS} steps at batch {GC_BATCH}: {ms:.2f} ms/step, last loss "
        f"{loss:.3f}; RK4-{GC_RK4} norm-corrected: max relative norm error "
        f"{rel:.3g} (rtol 1e-4)")
    if not (math.isfinite(loss) and torch.isfinite(xgen).all()
            and rel <= 1e-4 and sde.G is not None):
        raise AssertionError(f"GaussianCauchy MSGM: loss {loss}, norm error "
                             f"{rel}")

    # the CLI on the toy presets
    rec["cli"] = {preset: dense_cli_run(card, [
        "--preset", preset, "--iterations", str(CORE_CLI_ITERATIONS),
        "--eval-mmd", "--no-plots"]) for preset in CORE_CLI_PRESETS}
    return rec


def check_core_dit(g, dev, card):
    """Phase 27: grf16_dit (fp32) and grf16_production_dit (bf16) through
    the CLI with their checks and traces; then the core MLP path."""
    t0 = time.perf_counter()
    rec = {"card": card}
    rec["dit"] = msgm_cli_run(g, dev, card, DIT_ARGS, bf16=False)
    rec["dit_traces"] = dit_traces("grf16_dit", g, dev)
    rec["dit_production"] = msgm_cli_run(g, dev, card, DIT_PROD_ARGS,
                                         bf16=True)
    rec["dit_production_traces"] = dit_traces("grf16_production_dit", g, dev)
    rec["launches"] = {k: rec["dit"]["launches"][k]
                       + rec["dit_production"]["launches"][k]
                       for k in rec["dit"]["launches"]}
    rec["core"] = core_path(g, dev, card)
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 27: {rec['seconds']:.1f} s, launches in the two DiT runs "
        f"{dict((k, v) for k, v in rec['launches'].items() if v)}")
    return rec


# -- phase 28: the rest of the U-Net and serving export ----------------------
# the potential arm's SSM steps; the fp32 export's RK4 steps (RK4-32 took
# 231 s to export on an H100 80GB HBM3 host, past the 60 s that RK4-32 is
# given, so RK4-16); the encoder's RK4 steps; the symbolic batch's served
# sizes; the draws' seed
POT_SSM_STEPS, EXPORT_STEPS, ENCODER_STEPS = 8, 16, 4
SERVED_BATCHES = (N_SAMPLES, 256)
DRAW_SEED = 28
# the exported arms' weights: the worker and this process build them alike
EXPORT_SEED = 281
# seconds to wait for the worker's exports and for each served run
EXPORT_WAIT_S, SERVE_WAIT_S = 1200, 600
# a served program against eager on the same draws: expected equal
SERVED_TOL = 1e-6
# the checkpointed DSM step's gradients against the plain step's, as a share
# of the largest (fp32: K7b adds dQ by atomics, in an order that varies)
REMAT_GRAD_TOL = {"fp32": 1e-4, "bf16": 1e-3}
# the entry point of each kernel (common.Kernel.entry_launches keys)
ENTRY = {"circulant_apply": "circulant_apply",
         "circulant_rk4_step": "circulant_rk4_step",
         "circulant_rk4_solve": "circulant_rk4_solve_select",
         "fused_attention_block": "attn_block",
         "group_norm_silu": "group_norm_silu",
         "group_norm_silu_bwd": "group_norm_silu_bwd",
         "qkv_attention": "qkv_attention",
         "qkv_attention_flash": "qkv_attention_flash",
         "qkv_attention_stats": "qkv_attention_stats",
         "qkv_attention_bwd": "qkv_attention_bwd"}

# a served artifact loaded in a fresh process (the serving module alone: no
# sdeflow_tpu_torch.models or .sde; this script's float32 settings), then,
# once the file "go" appears in its directory, run twice on each input set
# in the files in<i>.pt there: its load seconds, each run's ms and the last
# run's launches, per kernel and per entry point, to result.json; the
# outputs to out<i>.pt
FRESH_RELOAD = r"""
import json, os, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from sdeflow_tpu_torch.ops.kernels import common
from sdeflow_tpu_torch.serving import Encoder, Sampler
path, tmp, sets = sys.argv[1], sys.argv[2], int(sys.argv[3])
t0 = time.perf_counter()
kind = json.load(open(path + ".json"))["kind"]
handle = (Sampler if kind == "sampler" else Encoder)(path)
load_s = time.perf_counter() - t0
while not os.path.exists(os.path.join(tmp, "go")):
    if time.perf_counter() - t0 > 900:
        sys.exit("no go after 900 s")
    time.sleep(0.05)
runs = []
for i in range(sets):
    args = [a.cuda() for a in torch.load(f"{tmp}/in{i}.pt")]
    ms = []
    for _ in range(2):
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = handle.program(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.save(out.cpu(), f"{tmp}/out{i}.pt")
    runs.append({"ms": ms, "launches": {
        k.name: k.launches for k in common.KERNELS.values()},
        "entries": {e: n for k in common.KERNELS.values()
                    for e, n in k.entry_launches.items()}})
bad = sorted(m for m in sys.modules if m.startswith(
    ("sdeflow_tpu_torch.models", "sdeflow_tpu_torch.sde")))
with open(os.path.join(tmp, "result.tmp"), "w") as f:
    json.dump({"modules": bad, "load_s": load_s, "runs": runs}, f)
os.replace(os.path.join(tmp, "result.tmp"), os.path.join(tmp, "result.json"))
"""

# the exporting worker: a process of its own (export_worker), started while
# the earlier phases run, so that its tracing (minutes of host time on one
# core) overlaps them
EXPORT_WORKER = r"""
import sys
import chip_smoke
chip_smoke.export_worker(sys.argv[1], int(sys.argv[2]))
"""


class PhaseLaunches:
    """The launches of a phase's main-path runs, per kernel entry point:
    ``run(fn)`` sets every count to 0 just before fn() and adds the counts
    just after."""

    def __init__(self):
        self.entries = collections.Counter()

    def run(self, fn, *args, **kwargs):
        from sdeflow_tpu_torch.ops.kernels import common

        common.reset_launches()
        rec = timed_call(fn, *args, **kwargs)
        self.entries.update(entry_counts())
        return rec


def potential_net(cfg, dev, **kw):
    """grf16's VorticityUNet (the driver's make_model knobs) with
    learn_potential, on dev."""
    from sdeflow_tpu_torch.models.vorticity import VorticityUNet

    tc = cfg.train
    return VorticityUNet(
        base_channels=tc.base_channels, channel_mults=tc.channel_mults,
        num_res_blocks=tc.num_res_blocks, premodule="NormalizeLogRadius",
        in_space=int(round(DIM**0.5)),
        attention_resolutions=tc.attention_resolutions, flatten_order="F",
        learn_potential=True, **kw).to(dev)


def potential_want(net, evals, k1=0, k2_solve=0):
    """Launches of `evals` score evaluations of a potential net (each the
    potential's forward, every block of it K3 or two K5, and its reverse
    pass with grad mode off: K5b for each K5) and of the SDE's K1 and K2
    solve."""
    from sdeflow_tpu_torch.models.unet2d import AttentionBlock, ResBlock
    from sdeflow_tpu_torch.ops.kernels import common

    res = sum(isinstance(m, ResBlock) for m in net.modules())
    attn = sum(isinstance(m, AttentionBlock) for m in net.modules())
    want = dict.fromkeys(common.KERNELS, 0)
    want.update(fused_attention_block=attn * evals,
                group_norm_silu=2 * res * evals,
                group_norm_silu_bwd=2 * res * evals, circulant_apply=k1,
                circulant_rk4_solve=k2_solve)
    return want


def held(what, got, want):
    got = {k: got[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return got


def check_potential(cfg, gen, g, dev, runs):
    """Phase 28 (a): grf16's learned potential at full width: the score on
    N_SAMPLES points against the plain path, the RK4-32 norm-corrected
    request (exact launches, norms, the plain replay) and POT_SSM_STEPS
    SSM steps at batch 128."""
    from sdeflow_tpu_torch import Trainer, make_sampler_fn
    from sdeflow_tpu_torch.experiments.driver import make_sampler

    net = potential_net(cfg, dev)
    randomize_(net, g)
    with torch.no_grad():
        # a gentle potential (|score| ~ 0.1): the gradient of a random net
        # makes the request's dynamics sensitive enough that at |score| ~ 1
        # a score 5e-6 off the plain path's ended 3.6 % off after 32 RK4
        # steps on an H100
        for conv in (net.core.mid_res1.out_conv, net.core.mid_res1.skip_conv):
            conv.weight.mul_(0.01)
    gen_p = dataclasses.replace(gen, score_net=net)
    rec = {}
    x = gen_p.latent_sample(g, N_SAMPLES, DIM)
    t = torch.rand(N_SAMPLES, generator=g, device=dev)
    with torch.no_grad():
        r = runs.run(net, x, t)
        with plain_path():
            ref = net(x, t)
    held("potential score", r["launches"], potential_want(net, 1))
    err = (r["out"] - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not (torch.isfinite(r["out"]).all() and err <= 1e-4 * scale):
        raise AssertionError(f"potential score: |kernel - plain| {err} of "
                             f"max {scale}")
    rec["score"] = dict(points=N_SAMPLES, max_abs_err=err, max_abs=scale,
                        ms=r["ms"])
    log(f"potential score on {N_SAMPLES} points: {r['ms']:.1f} ms, "
        f"|kernel - plain| {err:.3g} of max {scale:.3g} (gate 1e-4)")

    sample = make_sampler_fn(gen_p, N_SAMPLES, DIM, STEPS, method="rk4",
                             norm_correction=True, device=dev)
    x0 = gen_p.latent_sample(g, N_SAMPLES, DIM)
    noise = torch.randn(STEPS, N_SAMPLES, DIM, generator=g, device=dev)
    # cuDNN's deterministic algorithms for the request and its replay
    # (its default backward sums in an order that varies, phase 22)
    with swapped([(torch.backends.cudnn, "deterministic", True)]):
        r = runs.run(sample, g, x0=x0, noise=noise)
    want = potential_want(net, FORWARDS_PER_STEP * STEPS, K1_PER_STEP * STEPS)
    held("potential request", r["launches"], want)
    xs = r["out"]
    if not torch.isfinite(xs).all() or (xs - x0).abs().max().item() < 0.1:
        raise AssertionError("potential request: non-finite or unmoved")
    torch.testing.assert_close(xs.norm(dim=1), x0.norm(dim=1), rtol=1e-5,
                               atol=0)
    with plain_path(), swapped([(torch.backends.cudnn, "deterministic",
                                 True)]):
        p = timed_call(sample, g, x0=x0, noise=noise)
    rep = (xs - p["out"]).abs().max().item()
    top = p["out"].abs().max().item()
    if rep > 1e-3 * top:
        raise AssertionError(f"potential request replay {rep} of {top}")
    rec["request"] = dict(ms=r["ms"], samples_per_s=N_SAMPLES / r["ms"] * 1e3,
                          peak=r["peak"], launches=r["launches"],
                          plain_ms=p["ms"], replay_max_abs_err=rep,
                          max_abs=top)
    log(f"potential request, RK4-{STEPS} on {N_SAMPLES}: {r['ms']:.1f} ms "
        f"(plain {p['ms']:.1f}), peak {r['peak'] / 2**20:.0f} MiB, launches "
        f"{held('potential request', r['launches'], want)}, replay "
        f"{rep:.3g} of {top:.3g} (gate 1e-3)")

    sampler = make_sampler(cfg, DIM, dev)
    trainer = Trainer(gen_p, sampler, lr=cfg.train.lr,
                      batch_size=TRAIN_BATCH, loss="ssm", log_fn=log)

    def step():
        return trainer.train_step(trainer.state, g,
                                  sampler.sample(g, TRAIN_BATCH))[1]

    step_want = potential_want(net, 1, K1_PER_TRAIN, K2_SOLVE_PER_TRAIN)
    rec["ssm"] = runs.run(timed_train_steps, step, net, POT_SSM_STEPS,
                          step_want)["out"]
    return rec


def dsm_remat(make_arm, what, g, dev, runs):
    """Phase 28 (b): one DSM step of the grf U-Net at 128×128 (batch 128)
    with and without use_checkpoint, on the same draws, with cuDNN's
    deterministic algorithms: the loss equal, the gradients within
    REMAT_GRAD_TOL of the largest, peak memory, ms and launches both
    ways (the remat step reruns each block's K5, K6 and K7a)."""
    import copy

    _, model, gen, sampler = make_arm(g, dev)
    remat = copy.deepcopy(model)
    remat.core.use_checkpoint = True
    dim = SGM_NPIXEL**2
    x = sampler.sample(g, SGM_BATCH)
    t = gen.sample_t(g, SGM_BATCH)
    noise = torch.randn(SGM_BATCH, dim, generator=g, device=dev)
    inside = SGM_WANT["group_norm_silu"] - 1  # all but the head's
    want = {"plain": dict(SGM_WANT), "remat": dict(
        SGM_WANT, group_norm_silu=SGM_WANT["group_norm_silu"] + inside,
        qkv_attention=2 * SGM_WANT["qkv_attention"],
        qkv_attention_stats=2 * SGM_WANT["qkv_attention_stats"])}
    out = {}
    with swapped([(torch.backends.cudnn, "deterministic", True)]):
        for mode, net in (("plain", model), ("remat", remat), ("remat", remat),
                          ("plain", model)):
            gen_n = dataclasses.replace(gen, score_net=net)

            def dsm_step():
                net.zero_grad(set_to_none=True)
                loss = gen_n.dsm(None, x, t=t, noise=noise).mean()
                loss.backward()
                return loss.detach()

            r = runs.run(dsm_step)
            held(f"{what} DSM step ({mode})", r["launches"], want[mode])
            first = mode not in out
            out.setdefault(mode, dict(ms=[], peak=r["peak"], loss=r["out"],
                                      launches=r["launches"],
                                      grads=[p.grad.clone() for p in
                                             net.parameters()]))
            if not first:
                out[mode]["ms"].append(r["ms"])
    if not torch.equal(out["plain"]["loss"], out["remat"]["loss"]):
        raise AssertionError(f"{what}: remat loss {out['remat']['loss']} != "
                             f"{out['plain']['loss']}")
    gmax = max(a.abs().max().item() for a in out["plain"]["grads"])
    gerr = max((a - b).abs().max().item() for a, b in zip(
        out["plain"]["grads"], out["remat"]["grads"]))
    if gerr > REMAT_GRAD_TOL[what] * gmax:
        raise AssertionError(f"{what}: remat gradients {gerr} of {gmax}")
    rec = {m: {k: v for k, v in o.items() if k != "grads"} | dict(
        loss=o["loss"].item()) for m, o in out.items()}
    rec.update(grad_max_abs_err=gerr, grad_max_abs=gmax)
    log(f"{what} DSM step at batch {SGM_BATCH}, 128x128: plain "
        f"{rec['plain']['ms'][0]:.1f} ms, peak "
        f"{rec['plain']['peak'] / 2**20:.0f} MiB; use_checkpoint "
        f"{rec['remat']['ms'][0]:.1f} ms, peak "
        f"{rec['remat']['peak'] / 2**20:.0f} MiB; loss equal, gradients "
        f"{gerr:.3g} of {gmax:.3g}; launches {rec['remat']['launches']}")
    return rec


def forward_checks(g, dev, runs):
    """Phase 28 (c): a dims=3 and a dims=1 U-Net and a class-conditional
    grf16 U-Net (random weights), kernel path against the plain path
    within 1e-4 of the largest output."""
    from sdeflow_tpu_torch import get_preset
    from sdeflow_tpu_torch.models.unet2d import UNetModel

    tc = get_preset("grf16").train
    grf16 = dict(in_channels=1, model_channels=tc.base_channels,
                 out_channels=1, num_res_blocks=tc.num_res_blocks,
                 attention_resolutions=tc.attention_resolutions,
                 channel_mult=tc.channel_mults)
    cases = {
        # attention at 8³ (T = 512: K5 and K6) and 4³ (T = 64: K3)
        "dims3": (dict(grf16, in_space=16, num_res_blocks=1, dims=3),
                  (8, 1, 16, 16, 16), None),
        "dims1": (dict(grf16, in_space=256, dims=1), (64, 1, 256), None),
        "labels": (dict(grf16, in_space=16, num_classes=10),
                   (N_SAMPLES, 1, 16, 16), 10)}
    rec = {}
    for name, (kw, shape, classes) in cases.items():
        net = UNetModel(**kw).to(dev)
        randomize_(net, g)
        x = torch.randn(shape, generator=g, device=dev)
        t = torch.rand(shape[0], generator=g, device=dev)
        y = (None if classes is None else torch.randint(
            0, classes, (shape[0],), generator=g, device=dev))
        with torch.no_grad():
            r = runs.run(net, x, t, y=y)
            with plain_path():
                ref = net(x, t, y=y)
        err = (r["out"] - ref).abs().max().item()
        scale = ref.abs().max().item()
        launched = {k: v for k, v in r["launches"].items() if v}
        if not launched or err > 1e-4 * scale:
            raise AssertionError(f"{name}: launches {launched}, |kernel - "
                                 f"plain| {err} of {scale}")
        rec[name] = dict(shape=list(shape), max_abs_err=err, max_abs=scale,
                         launches=launched, ms=r["ms"])
        log(f"U-Net {name} {tuple(shape)}: |kernel - plain| {err:.3g} of "
            f"{scale:.3g}, launches {launched}")
    return rec


def exported(fn, path, *args, **kwargs):
    """fn (export_sampler or export_encoder) timed: its sidecar, seconds
    and artifact bytes."""
    t0 = time.perf_counter()
    meta = fn(*args, path=path, **kwargs)
    rec = dict(export_s=time.perf_counter() - t0, bytes=os.path.getsize(path))
    log(f"exported {os.path.basename(path)}: {rec['export_s']:.1f} s, "
        f"{rec['bytes']} bytes")
    return meta, rec


def export_arms(dev):
    """The arms phase 28 exports, with random weights from EXPORT_SEED:
    grf16's MSGM arm, grf16_production's MSGM arm and N_SAMPLES data points
    (the encoder's input). The worker and this process build them alike."""
    from sdeflow_tpu_torch import build_msgm_arm, get_preset
    from sdeflow_tpu_torch.experiments.driver import make_sampler

    g = torch.Generator(device=dev).manual_seed(EXPORT_SEED)
    arms = []
    for preset in ("grf16", "grf16_production"):
        cfg = get_preset(preset)
        _, gen = build_msgm_arm(cfg, g, device=dev)
        randomize_(gen.score_net, g)
        with torch.no_grad():
            gen.score_net.core.conv_out.weight.mul_(0.1)
        arms += [cfg, gen]
    return (*arms, make_sampler(arms[0], DIM, dev).sample(g, N_SAMPLES))


def arms_digest(gen, gen_p, x):
    """A float64 sum of every parameter, latent prior table and data point
    of export_arms, to hold the two builds to each other."""
    ts = [*gen.score_net.parameters(), *gen_p.score_net.parameters(),
          gen.base_sde.r_T, gen_p.base_sde.r_T, x]
    return [float(t.detach().double().abs().sum()) for t in ts]


def pc_knobs(sw):
    """The production preset's sampler knobs (norm-corrected)."""
    return dict(method=sw.backward_method, norm_correction=True,
                corrector_steps=sw.corrector_steps, snr=sw.snr)


def export_worker(tmp, main_pid, device="cuda"):
    """Phase 28's exports, in a process of their own: export_arms, then
    grf16_production's PC request with a symbolic batch, the fp32 MSGM
    request (RK4-EXPORT_STEPS, norm-corrected) and the PF-ODE encoder
    (RK4-ENCODER_STEPS), each timed into tmp/<name>/ and loaded at once by
    a fresh process (FRESH_RELOAD) that waits for its go; the records to
    tmp/exports.json; then waits for those processes (killing them if
    the main process is gone)."""
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.serving import export_encoder, export_sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        common.build_all()
    cfg, gen, cfg_p, gen_p, x = export_arms(dev)
    sw = cfg_p.sweep
    common_kw = dict(num_samples=N_SAMPLES, dim=DIM)
    jobs = [("production", export_sampler, gen_p, dict(
                num_steps=sw.num_stepss_backward[0], polymorphic_batch=True,
                **pc_knobs(sw)), len(SERVED_BATCHES)),
            ("msgm_fp32", export_sampler, gen, dict(
                num_steps=EXPORT_STEPS, method="rk4", norm_correction=True),
             1),
            ("encoder", export_encoder, gen, dict(
                num_steps=ENCODER_STEPS, method="rk4", norm_correction=True),
             1)]
    root = os.path.dirname(os.path.abspath(__file__))
    out, loaders = {"digest": arms_digest(gen, gen_p, x)}, []
    try:
        for name, fn, arm, kw, sets in jobs:
            d = os.path.join(tmp, name)
            os.makedirs(d)
            path = os.path.join(d, "artifact")
            meta, ex = exported(fn, path, arm, **common_kw, **kw)
            out[name] = dict(ex, path=path, dir=d, meta=meta)
            with open(os.path.join(d, "log"), "w") as f:
                loaders.append(subprocess.Popen(
                    [sys.executable, "-c", FRESH_RELOAD, path, d, str(sets)],
                    cwd=d, env=dict(os.environ, PYTHONPATH=root), stdout=f,
                    stderr=subprocess.STDOUT))
        with open(os.path.join(tmp, "exports.tmp"), "w") as f:
            json.dump(out, f)
        os.replace(os.path.join(tmp, "exports.tmp"),
                   os.path.join(tmp, "exports.json"))
        while any(p.poll() is None for p in loaders):
            os.kill(main_pid, 0)  # raises once the main process is gone
            time.sleep(0.5)
    finally:
        for p in loaders:
            if p.poll() is None:
                p.kill()
                p.wait()


class ExportJob:
    """export_worker in a process of its own session (so that stop() ends
    its loaders too), started with start() and stopped at exit."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp()
        self.proc = None
        atexit.register(self.stop)

    def start(self):
        root = os.path.dirname(os.path.abspath(__file__))
        self.log = open(os.path.join(self.tmp, "worker.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", EXPORT_WORKER, self.tmp,
             str(os.getpid())], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), stdout=self.log,
            stderr=subprocess.STDOUT, start_new_session=True)
        self.started = time.perf_counter()

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        if self.proc is not None:
            self.log.close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _tail(self, path):
        with open(path) as f:
            return f.read()[-3000:]

    def exports(self):
        """The worker's export records, once it has written them."""
        path = os.path.join(self.tmp, "exports.json")
        while not os.path.exists(path):
            if (self.proc.poll() is not None or time.perf_counter()
                    - self.started > EXPORT_WAIT_S):
                raise AssertionError("export worker: " + self._tail(
                    os.path.join(self.tmp, "worker.log")))
            time.sleep(0.5)
        with open(path) as f:
            return json.load(f)

    def serve(self, what, rec, eager, input_sets, runs):
        """The artifact of `rec` (loaded by its fresh process) served on
        each of `input_sets` against its eager program on the same inputs
        (each run twice, the last kept): max |Δ| within SERVED_TOL of the
        largest value (expected 0), equal launches; raises if that process
        imported the model or SDE modules. Returns the record and the
        served outputs."""
        d = rec["dir"]
        eagers = []
        for i, inputs in enumerate(input_sets):
            torch.save([a.cpu() for a in inputs], os.path.join(d, f"in{i}.pt"))
            with torch.no_grad():
                eagers.append([runs.run(eager, *inputs)
                               for _ in range(2)][-1])
        open(os.path.join(d, "go"), "w").close()
        path, t0 = os.path.join(d, "result.json"), time.perf_counter()
        while not os.path.exists(path):
            if time.perf_counter() - t0 > SERVE_WAIT_S:
                raise AssertionError(f"{what}: fresh process: "
                                     + self._tail(os.path.join(d, "log")))
            time.sleep(0.1)
        with open(path) as f:
            got = json.load(f)
        if got["modules"]:
            raise AssertionError(f"{what}: the serving process imported "
                                 f"{got['modules']}")
        out_rec, outs = dict(load_s=got["load_s"], runs=[]), []
        for i, (e, s) in enumerate(zip(eagers, got["runs"])):
            out = torch.load(os.path.join(d, f"out{i}.pt")).to(
                e["out"].device)
            runs.entries.update(s["entries"])
            top = e["out"].abs().max().item()
            diff = (out - e["out"]).abs().max().item()
            if (diff > SERVED_TOL * top or s["launches"] != e["launches"]
                    or not torch.isfinite(out).all()):
                raise AssertionError(f"{what}: served |Δ| {diff} of {top}, "
                                     f"launches {s['launches']} != "
                                     f"{e['launches']}")
            out_rec["runs"].append(dict(
                batch=out.shape[0], max_abs_diff=diff, max_abs=top,
                served_ms=s["ms"], eager_ms=e["ms"], eager_peak=e["peak"],
                launches={k: v for k, v in s["launches"].items() if v}))
            outs.append(out)
            log(f"{what}, batch {out.shape[0]}: served {s['ms'][-1]:.1f} ms "
                f"(first {s['ms'][0]:.1f}), eager {e['ms']:.1f} ms, max |Δ| "
                f"{diff:.3g} of {top:.3g}, launches "
                f"{out_rec['runs'][-1]['launches']}")
        log(f"{what}: exported in {rec['export_s']:.1f} s ({rec['bytes']} "
            f"bytes), loaded in {got['load_s']:.1f} s by a process without "
            "the model and SDE modules")
        return dict(rec, **out_rec), outs

    def finish(self):
        rc = self.proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError("export worker: " + self._tail(
                os.path.join(self.tmp, "worker.log")))


def check_exports(job, dev, runs):
    """Phase 28 (d): the worker's three exports (export_worker), each
    served by its fresh process against the eager program of the same
    arm, built here alike, on the same draws (ExportJob.serve)."""
    from sdeflow_tpu_torch import make_sampler_fn
    from sdeflow_tpu_torch.ops.ode import encode_ode
    from sdeflow_tpu_torch.serving import make_draws

    recs = job.exports()
    cfg, gen, cfg_p, gen_p, x = export_arms(dev)
    if arms_digest(gen, gen_p, x) != recs["digest"]:
        raise AssertionError("the exported arms differ from this build")
    draw_g = torch.Generator(device=dev).manual_seed(DRAW_SEED)
    sw = cfg_p.sweep
    steps = sw.num_stepss_backward[0]
    rec = {}

    samplers = {n: make_sampler_fn(gen_p, n, DIM, steps, device=dev,
                                   **pc_knobs(sw)) for n in SERVED_BATCHES}

    def eager_pc(*d):
        return samplers[d[0].shape[0]](
            None, x0=gen_p.base_sde.latent_from_draws(*d[:-2]), noise=d[-2],
            corrector_noise=d[-1])

    meta = recs["production"]["meta"]
    rec["production"], _ = job.serve(
        "production PC request (symbolic batch)", recs["production"],
        eager_pc, [make_draws(meta["inputs"], draw_g, n)
                   for n in SERVED_BATCHES], runs)
    rec["production"].update(steps=steps, inputs=[
        s["name"] for s in meta["inputs"]])

    draws = make_draws(recs["msgm_fp32"]["meta"]["inputs"], draw_g)
    sample = make_sampler_fn(gen, N_SAMPLES, DIM, EXPORT_STEPS, method="rk4",
                             norm_correction=True, device=dev)
    rec["msgm_fp32"], (xs,) = job.serve(
        f"fp32 MSGM request RK4-{EXPORT_STEPS}", recs["msgm_fp32"],
        lambda *d: sample(None, x0=gen.base_sde.latent_from_draws(*d[:-1]),
                          noise=d[-1]), [draws], runs)
    x0 = gen.base_sde.latent_from_draws(*draws[:-1])
    torch.testing.assert_close(xs.norm(dim=1), x0.norm(dim=1), rtol=1e-5,
                               atol=0)
    rec["msgm_fp32"]["steps"] = EXPORT_STEPS

    rec["encoder"], _ = job.serve(
        f"encoder RK4-{ENCODER_STEPS}", recs["encoder"],
        lambda xx: encode_ode(gen, xx, ENCODER_STEPS, method="rk4",
                              norm_correction=True), [[x]], runs)
    rec["encoder"]["steps"] = ENCODER_STEPS
    job.finish()
    for r in rec.values():
        for k in ("path", "dir", "meta"):
            r.pop(k, None)
    return rec


def check_unet_export(g, dev, card, job):
    """Phase 28: the rest of the 2D U-Net and serving export (module
    docstring); job is the ExportJob started before the earlier phases."""
    from sdeflow_tpu_torch import build_msgm_arm, get_preset

    t0 = time.perf_counter()
    runs = PhaseLaunches()
    cfg = get_preset("grf16")
    _, gen = build_msgm_arm(cfg, g, device=dev)
    randomize_(gen.score_net, g)
    with torch.no_grad():
        gen.score_net.core.conv_out.weight.mul_(0.1)
    rec = {"card": card}
    rec["potential"] = check_potential(cfg, gen, g, dev, runs)
    log(f"phase 28 at {time.perf_counter() - t0:.1f} s: remat")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")  # remat needs no fallback here
        rec["dsm_remat"] = {
            "fp32": dsm_remat(sgm_arm, "fp32", g, dev, runs),
            "bf16": dsm_remat(bf16_dsm_arm, "bf16", g, dev, runs)}
    if any("without remat" in str(w.message) for w in caught):
        raise AssertionError("the DSM step ran its blocks without remat")
    log(f"phase 28 at {time.perf_counter() - t0:.1f} s: forward checks")
    rec["forward"] = forward_checks(g, dev, runs)
    log(f"phase 28 at {time.perf_counter() - t0:.1f} s: exports")
    rec["exports"] = check_exports(job, dev, runs)
    rec["entry_launches"] = dict(runs.entries)
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 28: {rec['seconds']:.1f} s, launches by entry "
        f"{dict((k, v) for k, v in runs.entries.items() if v)}")
    return rec


# -- phase 29: the signal regime, file-backed Lorenz-63 data and UNet1D --------
# the fixture (tools/l63_fixture.py): windows of 1,000 steps of X, enough
# of them that the 2:1 split's train set holds N_SAMPLES rows; the CLI runs
# at phase 20's reduction on each arm's own batch (lorenz63's 256)
L63_DIM, L63_WINDOWS = 1000, 1536
SIGNAL_FLAGS = ["--iterations", str(DRIVER_ITERATIONS), "--num-samples",
                str(N_SAMPLES), "--steps-backward", str(STEPS), "--eval-mmd",
                "--no-plots"]


def k_rows(b, dim, g, dev):
    """K1 and K2 at (b, dim), bit for bit against their plain versions,
    plans mirrored, with their times and bounds (timed_row)."""
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K1, K2, _launch_k1, _launch_k2, circ_math, circulant_apply,
        circulant_plan, circulant_rk4_step, kernel_plan, rk4_math_fwd,
        rk4_plan)

    y = torch.randn(b, dim, generator=g, device=dev)
    w = torch.randn(b, dim, generator=g, device=dev)
    sb = 1.0 + torch.rand(b, 1, generator=g, device=dev)
    sb3 = 1.0 + torch.rand(b, 3, generator=g, device=dev)
    w2 = 0.25 * w
    rows = {}
    for kern, plan, fn, direct, plain, args, cost in (
            (K1, circulant_plan(b, dim), circulant_apply, _launch_k1,
             circ_math, (sb, y, w), k1_cost),
            (K2, rk4_plan(b, dim), circulant_rk4_step, _launch_k2,
             rk4_math_fwd, (sb3, y, w2), k2_cost)):
        if kernel_plan(kern, b, dim) != plan:
            raise AssertionError(f"{kern.name} ({b}, {dim}): plan mirror "
                                 f"{plan} != {kernel_plan(kern, b, dim)}")
        out = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        err = (out - ref).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"{kern.name} ({b}, {dim}) differs from its "
                                 f"plain version by {err:.3g}")
        rows[kern.name] = r = dict(timed_row(kern, plan, fn, direct, plain,
                                             args, cost), max_abs_err=err)
        log(f"{kern.name} ({b}, {dim}) {plan.kind} plan ({plan.per_lane} "
            f"floats per lane, vec {plan.vec}): bit for bit with its plain "
            f"version; device {r['device_ms_alone']:.5f} ms (launch floor "
            f"{r['floor_ms']:.5f} ms), bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), per call {r['ms']:.4f} ms, direct "
            f"{r['direct_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return rows


def dense_cli_run(card, args):
    """``run.main`` with args on a preset with a dense G and the MLP
    (swissroll, gaussian, cauchy, lorenz63) in a temporary cwd and results
    directory: no kernel launched, each MSGM arm's G of d³, finite
    metrics."""
    import tempfile

    import numpy as np

    from sdeflow_tpu_torch import run as run_mod
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops.kernels import common

    builds = []
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with spied(drv, "build_msgm_arm", builds):
                common.reset_launches()
                t0 = time.perf_counter()
                res = run_mod.main([*args, "--results-dir",
                                    os.path.join(tmp, "results")])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = launch_counts()
        finally:
            os.chdir(cwd)
    what = args[args.index("--preset") + 1]
    if any(launches.values()):
        raise AssertionError(f"{what} launched {launches}")
    G = [list(b["out"][1].base_sde.G.shape) for b in builds]
    if G != [[d] * 3 for d in res["dims"]]:
        raise AssertionError(f"{what}: dense G {G} for dims {res['dims']}")
    sq = {k: np.sqrt(np.maximum(res[k], 0)).ravel().tolist()
          for k in ("mmd_sgm", "mmd_msgm", "mmd_ref")}
    if not all(np.isfinite(v).all() for v in sq.values()):
        raise AssertionError(f"{what}: sqrt-MMD {sq}")
    log(f"{card}: CLI {what}: {seconds:.1f} s, no kernel launched, dims "
        f"{res['dims']}, dense G {G}; sqrt-MMD SGM "
        f"{[round(v, 4) for v in sq['mmd_sgm']]}, MSGM "
        f"{[round(v, 4) for v in sq['mmd_msgm']]}, floor "
        f"{[round(v, 4) for v in sq['mmd_ref']]}")
    return dict(seconds=seconds, dims=res["dims"], G=G, sqrt_mmd=sq)


def check_signal(g, dev, card):
    """Phase 29: a Lorenz-63 fixture written under a temporary root, then
    through the CLI with --data-root: lorenz63_unet1d (UNet1D at full
    width, d = 1000, the circulant MSGM SDE) with msgm_cli_run's checks;
    K1 and K2 at its SSM step's and its request's shapes and K2's 16-step
    solve, bit for bit against their plain versions, timed; a traced MSGM
    SSM step and 2-step request; lorenz63_dit likewise; lorenz63 (d = 16,
    dense G, MLP) with no kernel."""
    import tempfile

    from sdeflow_tpu_torch import build_msgm_arm, get_preset
    from sdeflow_tpu_torch.data import get_data_root, set_data_root

    t_start = time.perf_counter()
    cfg = get_preset("lorenz63_unet1d")
    tc, batch = cfg.train, cfg.sweep.batch_sizes[0]
    if (cfg.data.dims, tc.nn_archi, tc.dense_tensor, tc.num_steps_forward,
            L63_DIM % 32 == 0) != ((L63_DIM,), "Unet1D", False, 16, False):
        raise AssertionError("lorenz63_unet1d: not the circulant d = 1000 "
                             "UNet1D preset of 16 forward steps")
    rec = {"card": card}
    prev_root = get_data_root()
    with tempfile.TemporaryDirectory() as root:
        from tools.l63_fixture import ensure_fixture

        t0 = time.perf_counter()
        ensure_fixture(root, window_len=L63_DIM, n_windows=L63_WINDOWS)
        rec["fixture_s"] = time.perf_counter() - t0
        log(f"Lorenz-63 fixture of {L63_WINDOWS} windows x {L63_DIM}: "
            f"{rec['fixture_s']:.1f} s")

        def args(preset):
            return ["--preset", preset, "--data-root", root, *SIGNAL_FLAGS]

        try:
            set_data_root(root)  # for the arms built here; the CLI sets it
            rec["unet1d"] = msgm_cli_run(g, dev, card,
                                         args("lorenz63_unet1d"), bf16=False,
                                         net_type="UNet1D", dim=L63_DIM)
            _, gen = build_msgm_arm(cfg, g, device=dev)  # the CLI's root
            with torch.no_grad():
                rec["k"] = {f"{b}x{L63_DIM}": k_rows(b, L63_DIM, g, dev)
                            for b in (batch, N_SAMPLES)}
                rec["solve"] = check_solve(gen, g, dev, b=batch, dim=L63_DIM,
                                           steps=tc.num_steps_forward,
                                           what="lorenz63_unet1d")
            rec["unet1d_traces"] = dit_traces("lorenz63_unet1d", g, dev,
                                              dim=L63_DIM, randomize=False)
            rec["dit"] = msgm_cli_run(g, dev, card, args("lorenz63_dit"),
                                      bf16=False, net_type="DiT1D",
                                      dim=L63_DIM)
            rec["dense"] = dense_cli_run(card, args("lorenz63"))
        finally:
            set_data_root(prev_root)
    rec["launches"] = {k: rec["unet1d"]["launches"][k]
                       + rec["dit"]["launches"][k] for k in
                       rec["unet1d"]["launches"]}
    rec["seconds"] = time.perf_counter() - t_start
    log(f"phase 29: {rec['seconds']:.1f} s, launches in the three CLI runs "
        f"{dict((k, v) for k, v in rec['launches'].items() if v)}")
    return rec


# -- phase 30: the plots and the profiling utilities ---------------------------
# the CLI with its default figures: grf16 at phase 20's reduction with
# --print-ram, and lorenz63_unet1d on phase 29's fixture at its reduction;
# each MSGM arm's noising trajectory (the test set, num_steps_forward RK4
# steps: grf16 64 at (1024, 256) on K2's warp plan, lorenz63_unet1d 16 at
# (1024, 1000) on its general plan) is K2's single step on the CLI
PLOT_ARGS = [*(a for a in DRIVER_ARGS if a != "--no-plots"), "--print-ram"]
PLOT_SIGNAL_FLAGS = [a for a in SIGNAL_FLAGS if a != "--no-plots"]
# the launches of those runs besides the noising trajectories: phase 20's
# driver run and phase 29's lorenz63_unet1d run (both arms' 8 SSM steps,
# the ELBO prints at steps 1 and 8, one request each), from the code
DRIVER_LAUNCHES = {"circulant_apply": 306, "circulant_rk4_solve": 10,
                   "fused_attention_block": 3036, "group_norm_silu": 9660,
                   "group_norm_silu_bwd": 560}
SIGNAL_LAUNCHES = {"circulant_apply": 306, "circulant_rk4_solve": 10}
TRACE_CALLS = 200  # K1 calls in each of check_utils' traces
# (what, seconds slept in the window before the calls, a synchronize
# after each call)
TRACE_WINDOWS = (("at once", 0.0, False), ("after a 20 ms lead", 0.02, False),
                 ("each synchronized", 0.0, True))


def cli_config(args):
    """The preset of a CLI argument list with its sweep overrides, as
    ``run.main`` builds it."""
    from sdeflow_tpu_torch import get_preset

    def flag(name, cast):
        return cast(args[args.index(name) + 1])

    cfg = get_preset(flag("--preset", str))
    return dataclasses.replace(cfg, sweep=dataclasses.replace(
        cfg.sweep, iterationss=(flag("--iterations", int),),
        num_samples=flag("--num-samples", int),
        num_stepss_backward=(flag("--steps-backward", int),)))


def jax_plot_files(cfg, names, complexitys):
    """Every file the JAX driver writes with its figures on and eval_mmd
    for cfg (one dimension, iteration count, batch size, step count and
    run), names the two arms' samplers' (SGM, MSGM), relative to the
    results directory (sdeflow_tpu/experiments/driver.py:384-422, 466-481,
    592-615, 702-767 and sdeflow_tpu/plotting/plots.py)."""
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.experiments.naming import (
        run_name_root, simulation_name)

    tc, sw, dim = cfg.train, cfg.sweep, cfg.data.dims[0]
    steps = sw.num_stepss_backward[0]
    n_dup = min(10, sw.num_samples)
    kind = ("image" if dim == int(round(dim**0.5))**2 and dim >= 256
            else "timeserie")
    files = {f"global{m}file_{a}_1runs.npy" for m in ("MMD", "SWD")
             for a in ("SGM", "MSGM", "ref")}
    files |= {f"MMD_wBckWardSteps_d={dim}_Ntrain={c}.png"
              for c in complexitys}
    for is_msgm, name in zip((False, True), names):
        files.add(name + ".png")  # the test set's pair grid
        batch, iters = drv.fair_budgets(
            cfg, is_msgm, sw.ssm_intT_ref and is_msgm, dim,
            sw.batch_sizes[0], sw.iterationss[0], log_fn=lambda *_: None)
        root = run_name_root(
            name, "MSGM_sparseTenslogNorm" if is_msgm else "SGM",
            sw.iterationss[0], drv.init_samples(cfg, iters, batch), batch,
            tc.num_steps_forward, tc.beta_min, tc.beta_max, tc.beta_min_sgm,
            tc.beta_max_sgm, is_msgm, nn_archi=tc.nn_archi,
            premodule="NormalizeLogRadius" if is_msgm else None, lr=tc.lr,
            vtype=tc.vtype, ssm_intT=sw.ssm_intT_ref and is_msgm,
            fair_comparison=sw.fair_comparison)
        fwd = range(0, tc.num_steps_forward + 1,
                    max(1, tc.num_steps_forward // 8))
        files |= {root + s for s in ("_cov.png", "_Forward.png",
                                     "_checkpoint_final")}
        files |= {f"{root}_Forward_{kind}Att{i}_sample{k}_.png" for i in fwd
                  for k in range(n_dup if i == 0 else 1)}
        sim = os.path.relpath(simulation_name(
            ".", root, tc.t_eps, steps, sw.include_t0_reverse), ".")
        files |= {sim + s for s in (".npy", "_traj.npy", ".png",
                                    "_multDim.png", "_survival.png")}
        files |= {f"{sim}_Gen_{kind}Att{i}_sample{k}_.png"
                  for i in range(0, steps + 1, max(1, steps // 8))
                  for k in range(n_dup if i == steps else 1)}
    return sorted(files)


def check_noising(what, r, is_msgm, n_steps, plan):
    """A noising trajectory's record (timed_call of integrate_sde): its
    shape, finite, norms kept (MSGM), exactly n_steps K2 single steps on
    the MSGM arm on `plan` and no kernel on the SGM arm, and its replay on
    the plain path from the same draws bit for bit."""
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops.kernels.circulant import rk4_plan

    xs, xtest = r["out"], r["args"][1]
    n, d = xtest.shape
    if tuple(xs.shape) != (n_steps + 1, n, d) or \
            not torch.isfinite(xs).all():
        raise AssertionError(f"{what}: noising trajectory {tuple(xs.shape)}")
    want = {k: 0 for k in r["launches"]}
    if is_msgm:
        want["circulant_rk4_step"] = n_steps
        if rk4_plan(n, d).kind != plan:
            raise AssertionError(f"{what}: K2 at {(n, d)} takes the "
                                 f"{rk4_plan(n, d).kind} plan, not {plan}")
    if r["launches"] != want:
        raise AssertionError(f"{what}: noising launches {r['launches']} != "
                             f"{want}")
    norms = xs.norm(dim=2)
    kept = bool(torch.allclose(norms, norms[0].expand_as(norms), rtol=1e-5,
                               atol=0))
    if kept is not is_msgm:
        raise AssertionError(f"{what}: noising norms kept = {kept}")
    xp, launches, plain_ms = replayed(r, drv.integrate_sde)
    if any(launches.values()) or not torch.equal(xs, xp):
        raise AssertionError(f"{what}: the noising trajectory's plain replay "
                             f"differs by {(xs - xp).abs().max().item():.3g} "
                             f"(launches {launches})")
    out = dict(shape=list(xs.shape), ms=r["ms"], plain_ms=plain_ms,
               launches=r["launches"], k2_plan=plan if is_msgm else None)
    log(f"{what} noising trajectory {tuple(xs.shape)}: {r['ms']:.1f} ms, "
        f"K2 {r['launches']['circulant_rk4_step']} single steps"
        f"{f' ({plan} plan)' if is_msgm else ''}, norms kept {kept}, bit "
        f"for bit with its plain replay ({plain_ms:.1f} ms)")
    return out


def figure_numbers(numbers):
    """Where the card has no matplotlib: the driver's plotting calls
    swapped for their figures' numbers through the port's functions, on
    the card's tensors, drawn nowhere. The up-front check passes; each
    test set's pair grid is its columns (def_pd) and their histograms;
    the noising report its forward-convergence stats, covariance panels
    and film strip's 2D histograms; each run's postprocessing runs without
    its figures (make_plots=False: the .npy and the metric block), then
    its pair grid's step histograms and KDE curves, its survival curves
    and its denoising strip's 2D histograms; the convergence plots are the
    square roots of the saved MMD² arrays (negatives at 0, as drawn).
    Each call appends (figure,
    every number finite) to `numbers`."""
    import numpy as np

    from sdeflow_tpu_torch.eval import forward_convergence_stats
    from sdeflow_tpu_torch.eval.diagnostics import filter_blowups
    from sdeflow_tpu_torch.eval.survival import survival_analysis
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.plotting import plots as P

    def finite(*arrays):
        return all(a is not None and np.isfinite(
            np.asarray(a, dtype=np.float64)).all() for a in arrays)

    def frame(x, std_norm, std_test_plot, datatype, kw):
        keys = ("dimplot", "offset_dimplot", "crop_data_plot", "plot_crop",
                "columns_plot")
        return P.def_pd(x, std_norm, std_test_plot, datatype,
                        **{k: kw[k] for k in keys if k in kw})

    def strip(xs, inds, std_test_plot, kw):
        off = kw.get("offset_dimplot", 0)
        val = kw.get("val_hist", 3.0) * (
            P._np(std_test_plot)[off] if std_test_plot is not None else 1.0)
        return [P.histogram_2d(xs[i], val, off)[0] for i in inds]

    def pair_grid(xtest, std_norm, std_test_plot, datatype, name_simu,
                  **kw):
        test = frame(xtest, std_norm, std_test_plot, datatype, kw)
        hists = [np.histogram(c[np.isfinite(c)], bins="auto")[0]
                 for c in test.values.T]
        numbers.append(("test set pair grid", finite(test.values, *hists)))

    def noising(xtest, xs_forward, num_steps_forward, name_simu_root,
                noising_plots=True, std_test_plot=None, log_fn=print, **kw):
        stats = {k: float(v) for k, v in forward_convergence_stats(
            xtest, xs_forward[-1]).items()}
        log_fn(f"forward convergence {stats}")
        panels = P.covariance_panels(xtest, xs_forward[-1])
        inds = range(0, num_steps_forward + 1,
                     max(1, num_steps_forward // 8))
        hists = strip(xs_forward, inds, std_test_plot, kw) \
            if noising_plots else []
        numbers.append(("noising report", finite(
            list(stats.values()), *panels.values(), *hists)))
        return stats

    def post(inds, xs, xtest, std_norm, std_test_plot, datatype, name_simu,
             **kw):
        out = P.postprocessing(inds, xs, xtest, std_norm, std_test_plot,
                               datatype, name_simu, **dict(kw,
                                                           make_plots=False))
        xgen = filter_blowups(xs[-1])[0]
        test, gen = (frame(x, std_norm, std_test_plot, datatype, kw)
                     for x in (xtest, xgen))
        curves = [P.step_histogram(c) for c in test.values.T]
        curves += [P.kde_curve(c) for c in gen.values.T]  # None: not drawn
        out["survival"] = surv = survival_analysis(x=xgen, x_ref=xtest)
        numbers.append(("run", finite(
            *(a for c in curves for a in (c or (None,))),
            surv["reference"]["S"], surv["generated"]["S"],
            *strip(xs, inds, std_test_plot, kw))))
        return out

    def convergence(self, folder):
        numbers.append(("convergence", finite(*(
            np.sqrt(np.maximum(self.results[k], 0.0))
            for k in ("mmd_sgm", "mmd_msgm", "mmd_ref")))))

    return swapped([(drv, "require_matplotlib", lambda: None),
                    (drv, "pairplots_single", pair_grid),
                    (drv, "preprocessing", noising),
                    (drv, "postprocessing", post),
                    (drv.ExperimentDriver, "_convergence_plots",
                     convergence)])


def plots_cli_run(card, args, want_rest, n_steps, plan, draw, ram=False):
    """``run.main(args)`` with its figures on in a temporary cwd and results
    directory, every kernel count set to 0 just before and read just
    after: each arm's noising trajectory (check_noising), the run's other
    launches equal to want_rest, the seconds inside the plotting calls
    (their metric block excluded) against the run's, and with ram each
    ``RAM:`` line's card figures against ``torch.cuda.memory_stats`` at
    that moment. With draw, every file the JAX driver writes for the
    preset present and nothing else, each non-empty; without (no
    matplotlib), the figures' numbers instead (figure_numbers), each
    finite, and the files that are not figures."""
    import tempfile

    import numpy as np

    from sdeflow_tpu_torch import run as run_mod
    from sdeflow_tpu_torch.experiments import driver as drv
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.plotting import plots as plots_mod
    from sdeflow_tpu_torch.training import train as train_mod

    what = args[args.index("--preset") + 1]
    fwd, samplers, drawn, metrics, lines, numbers = [], [], [], [], [], []
    report = train_mod.memory_report

    def reported():  # the line, then the allocator's figures at once
        line = report()
        lines.append((line, torch.cuda.memory_stats()))
        return line

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        results_dir = os.path.join(tmp, "results")
        os.chdir(tmp)
        try:
            with contextlib.ExitStack() as stack:
                if not draw:  # entered first: the spies below wrap these
                    stack.enter_context(figure_numbers(numbers))
                for module, name, calls in (
                        (drv, "integrate_sde", fwd),
                        (drv, "make_sampler", samplers),
                        (drv, "pairplots_single", drawn),
                        (drv, "preprocessing", drawn),
                        (drv, "postprocessing", drawn),
                        (drv.ExperimentDriver, "_convergence_plots", drawn),
                        (plots_mod, "sample_metrics", metrics)):
                    stack.enter_context(spied(module, name, calls))
                stack.enter_context(swapped([(train_mod, "memory_report",
                                              reported)]))
                common.reset_launches()
                t0 = time.perf_counter()
                results = run_mod.main([*args, "--results-dir", results_dir])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = launch_counts()
            files = sorted(os.path.relpath(os.path.join(d, f), results_dir)
                           for d, _, fs in os.walk(results_dir) for f in fs)
            empty = [f for f in files
                     if not os.path.getsize(os.path.join(results_dir, f))]
        finally:
            os.chdir(cwd)
    rec = {"card": card, "args": args, "seconds": seconds,
           "launches": launches}
    if len(fwd) != 2:
        raise AssertionError(f"{what}: {len(fwd)} noising trajectories")
    cfg = cli_config(args)
    n_fwd = cfg.train.num_steps_forward
    rec["noising"] = {arm: check_noising(f"{what} {arm}", r, is_msgm, n_fwd,
                                         plan)
                      for (arm, is_msgm), r in zip(
                          (("SGM", False), ("MSGM", True)), fwd)}
    rest = {k: n - sum(r["launches"][k] for r in fwd)
            for k, n in launches.items()}
    want = {k: want_rest.get(k, 0) for k in launches}
    if rest != want:
        raise AssertionError(f"{what}: launches besides the noising "
                             f"trajectories {rest} != {want}")
    for k in drv.METRICS:
        if not np.isfinite(results[k]).all():
            raise AssertionError(f"{what}: results[{k!r}] = {results[k]}")

    names = [s["out"].name for s in samplers]
    want_files = jax_plot_files(cfg, names, results["complexitys"])
    if not draw:  # the figures' numbers, and the files besides the figures
        calls = collections.Counter(f for f, _ in numbers)
        bad = [f for f, ok in numbers if not ok]
        if calls != {"test set pair grid": 2, "noising report": 2,
                     "run": 2, "convergence": 1} or bad:
            raise AssertionError(f"{what}: figure numbers {dict(calls)}, "
                                 f"not finite in {bad}")
        rec["figure_numbers"] = dict(calls)
        want_files = [f for f in want_files if not f.endswith(".png")]
    if files != want_files or empty:
        raise AssertionError(
            f"{what}: files absent {sorted(set(want_files) - set(files))}, "
            f"unexpected {sorted(set(files) - set(want_files))}, empty "
            f"{empty}")
    rec["figures"] = sum(f.endswith(".png") for f in files)
    plot_s = (sum(r["ms"] for r in drawn)
              - sum(r["ms"] for r in metrics)) / 1e3
    rec["plot_s"], rec["plot_share"] = plot_s, plot_s / seconds
    log(f"{card}: {what} with figures "
        f"{'drawn' if draw else 'as numbers (no matplotlib)'}: "
        f"{seconds:.1f} s, of which {plot_s:.1f} s "
        f"({rec['plot_share']:.1%}) in the plotting calls; "
        f"{rec['figures']} figures, all {len(want_files)} files "
        f"{'the JAX driver writes' if draw else 'besides the figures'} "
        f"present and non-empty; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")

    if ram:
        if len(lines) != 2 * 2:  # the prints at steps 1 and 8, per arm
            raise AssertionError(f"{what}: {len(lines)} RAM lines")
        pattern = re.compile(r"RAM: host rss ([\d,]+) MiB, device in_use "
                             r"([\d,]+) MiB peak ([\d,]+) MiB limit "
                             r"([\d,]+) MiB")
        for line, stats in lines:
            m = pattern.fullmatch(line)
            want_mib = [f"{stats[k] / 2**20:,.0f}" for k in (
                "allocated_bytes.all.current", "allocated_bytes.all.peak")]
            if not m or [m.group(2), m.group(3)] != want_mib:
                raise AssertionError(f"{what}: {line!r} against the "
                                     f"allocator's {want_mib} MiB")
        rec["ram_lines"] = [line for line, _ in lines]
        log(f"{card}: {len(lines)} RAM lines, each card figure equal to "
            f"torch.cuda.memory_stats at that moment; the last: "
            f"{lines[-1][0]}")
    return rec


def check_utils(g, dev, card, k1_ms=None):
    """The profiling utilities on the card: device_seconds of K1 at
    (1024, 256) against its CUDA-event time per call (phase 2's, measured
    again here), memory_report's card figures against
    torch.cuda.memory_stats, peak_flops' entry for the card's name, and a
    trace naming K1's kernel."""
    import tempfile

    from sdeflow_tpu_torch.ops.kernels.circulant import circulant_apply
    from sdeflow_tpu_torch.utils import profiling

    y = torch.randn(N_SAMPLES, DIM, generator=g, device=dev)
    w = torch.randn(N_SAMPLES, DIM, generator=g, device=dev)
    sb = 1.0 + torch.rand(N_SAMPLES, 1, generator=g, device=dev)
    rec = {"card": card}
    with torch.no_grad():
        ms = cuda_ms(lambda: circulant_apply(sb, y, w), 200)
        secs = profiling.device_seconds(
            lambda i: circulant_apply(sb, y, w)[i % N_SAMPLES, 0])
    ref = k1_ms if k1_ms is not None else ms
    rec.update(k1_device_seconds_ms=secs * 1e3, k1_cuda_event_ms=ms,
               k1_phase2_ms=k1_ms)
    log(f"{card}: device_seconds of K1 at ({N_SAMPLES}, {DIM}): "
        f"{secs * 1e3:.4f} ms a step (with one add) against "
        f"{ref:.4f} ms a call by CUDA events "
        f"({'phase 2' if k1_ms is not None else 'measured here'})")
    if not 0.5 <= secs * 1e3 / ref <= 2.0:
        raise AssertionError("device_seconds of K1 is not within a factor "
                             "of 2 of its CUDA-event time")

    line, stats = profiling.memory_report(), torch.cuda.memory_stats()
    total = torch.cuda.mem_get_info()[1]
    want = [f"{v / 2**20:,.0f}" for v in (
        stats["allocated_bytes.all.current"],
        stats["allocated_bytes.all.peak"], total)]
    m = re.fullmatch(r"RAM: host rss [\d,]+ MiB, device in_use ([\d,]+) MiB "
                     r"peak ([\d,]+) MiB limit ([\d,]+) MiB", line)
    if not m or list(m.groups()) != want:
        raise AssertionError(f"memory_report {line!r} against {want} MiB")
    rec["memory_report"] = line

    name = torch.cuda.get_device_name(0)
    entry = next((v for k, v in profiling.PEAK_FLOPS.items()
                  if k in name.lower()), None)
    peak = profiling.peak_flops()
    if entry is None or peak is not entry:
        raise AssertionError(f"peak_flops for {name!r}: {peak}")
    rec["peak_flops"] = peak

    rec["trace"] = {}
    for what, lead_s, sync in TRACE_WINDOWS:
        with tempfile.TemporaryDirectory() as tmp:
            with torch.no_grad():
                circulant_apply(sb, y, w)
                torch.cuda.synchronize()
                with profiling.trace(tmp) as prof:
                    time.sleep(lead_s)
                    for _ in range(TRACE_CALLS):
                        circulant_apply(sb, y, w)
                        if sync:
                            torch.cuda.synchronize()
            with open(os.path.join(tmp, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        # K1's kernel as the profiler saw it on the card, then in the file,
        # with the operator and launch calls on the host
        seen = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and SYMBOL["circulant_apply"] in e.name]
        k1 = {e.name for e in seen}
        counts = dict(
            profiler=len(seen),
            file=sum(e.get("name") in k1 for e in events),
            ops=sum(e.get("name") == "sdeflow::circulant_apply"
                    for e in events),
            launch_calls=sum(e.get("cat") == "cuda_runtime"
                             and "LaunchKernel" in e.get("name", "")
                             for e in events))
        kernel_ts = [e["ts"] for e in events if e.get("name") in k1]
        op_ts = [e["ts"] for e in events
                 if e.get("name") == "sdeflow::circulant_apply"]
        if kernel_ts and op_ts:  # µs from the first operator call
            counts["first_kernel_after_first_op_us"] = min(kernel_ts) - \
                min(op_ts)
        rec["trace"][what] = counts
        log(f"{card}: trace of {TRACE_CALLS} K1 calls {what}: {counts}")
        if counts["file"] != counts["profiler"] or not counts["file"]:
            raise AssertionError(f"trace.json holds {counts['file']} K1 "
                                 f"kernels, the profiler saw "
                                 f"{counts['profiler']}")
    log(f"{card}: memory_report {line!r} equal to torch.cuda.memory_stats; "
        f"peak_flops {peak}")
    return rec


def check_plots(g, dev, card, k1_ms=None, driver_launches=None):
    """Phase 30: whether matplotlib is on the card; the profiling
    utilities (check_utils); where matplotlib is absent, both runs'
    ImportError before anything is built; then the CLI with its figures on
    grf16 (phase 20's flags without --no-plots, with --print-ram) and on
    lorenz63_unet1d (phase 29's, on a fixture), plots_cli_run's checks,
    the figures drawn or, without matplotlib, their numbers."""
    import tempfile

    from sdeflow_tpu_torch import run as run_mod
    from sdeflow_tpu_torch.data import get_data_root, set_data_root

    t_start = time.perf_counter()
    try:
        import matplotlib
        version = matplotlib.__version__
    except ImportError:
        version = None
    rec = {"card": card, "matplotlib": version}
    log(f"{card}: matplotlib importable: "
        f"{'yes, ' + version if version else 'no'}")
    rec["utils"] = check_utils(g, dev, card, k1_ms)
    if driver_launches is not None and any(
            driver_launches[k] != n for k, n in DRIVER_LAUNCHES.items()):
        raise AssertionError(f"phase 20 launched {driver_launches}, not "
                             f"{DRIVER_LAUNCHES}")
    prev_root = get_data_root()
    with tempfile.TemporaryDirectory() as root:
        from tools.l63_fixture import ensure_fixture

        ensure_fixture(root, window_len=L63_DIM, n_windows=L63_WINDOWS)
        signal_args = ["--preset", "lorenz63_unet1d", "--data-root", root,
                       *PLOT_SIGNAL_FLAGS]
        try:
            if not version:
                for args in (PLOT_ARGS, signal_args):
                    with tempfile.TemporaryDirectory() as tmp:
                        res = os.path.join(tmp, "results")
                        try:
                            run_mod.main([*args, "--results-dir", res])
                        except ImportError as e:
                            if "--no-plots" not in str(e) or \
                                    os.path.exists(res):
                                raise
                        else:
                            raise AssertionError("a CLI run drew without "
                                                 "matplotlib")
                log("both CLI runs raised ImportError naming --no-plots "
                    "before building")
            rec["grf16"] = plots_cli_run(card, PLOT_ARGS, DRIVER_LAUNCHES,
                                         64, "warp", bool(version), ram=True)
            rec["lorenz63_unet1d"] = plots_cli_run(
                card, signal_args, SIGNAL_LAUNCHES, 16, "general",
                bool(version))
        finally:
            set_data_root(prev_root)
    runs = [rec["grf16"], rec["lorenz63_unet1d"]]
    if version:
        log(f"plots rendered: yes (matplotlib {version}), "
            f"{sum(r['figures'] for r in runs)} PNGs")
    else:
        log("plots rendered: no (matplotlib absent); both CLI runs went "
            "through the driver with the figures' numbers computed on the "
            "card and no PNG written")
    rec["launches"] = {k: sum(r["launches"][k] for r in runs)
                       for k in runs[0]["launches"]}
    rec["seconds"] = time.perf_counter() - t_start
    log(f"phase 30: {rec['seconds']:.1f} s, launches "
        f"{dict((k, v) for k, v in rec['launches'].items() if v)}")
    return rec


def write_record(path, record):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", metavar="PATH",
                    help="write the full record as JSON to PATH")
    ap.add_argument("--only", choices=("gn", "driver", "bf16", "k7",
                                       "unfused_bf16", "attn_bf16",
                                       "samplers", "core_dit",
                                       "unet_export", "signal", "plots"),
                    help="build the kernels and run only this part: gn "
                    "times K5 and K5b at both GroupNorm mixes with a traced "
                    "DSM step; driver runs phase 20, the experiment driver "
                    "on grf16; bf16 runs phases 21 and 22, the bf16 kernels "
                    "and the grf16_production preset; k7 times K7a, K7b and "
                    "the DSM step (k7_timing); unfused_bf16 runs phases 23, "
                    "24 and 25, the bf16 attention kernels, the bf16 grf "
                    "U-Net at 128x128 and grf16_production on the unfused "
                    "route; attn_bf16 times K6, K4, K7a and K7b bf16 at the "
                    "DSM step's and the request's shapes, the bf16 DSM step, "
                    "the bf16 request and grf16_production's unfused SSM "
                    "step and request (attn_bf16_timing); samplers runs "
                    "phase 26, the PF-ODE and DPM-Solver samplers and the "
                    "exact NLL through the CLI on grf16; core_dit runs "
                    "phase 27, the DiT presets and the core MLP path; "
                    "unet_export runs phase 28, the learned potential, "
                    "remat, the U-Net's other options and serving export; "
                    "signal runs phase 29, the Lorenz-63 presets on a "
                    "fixture through --data-root; plots runs phase 30, the "
                    "profiling utilities and the CLI with its figures on "
                    "grf16 and lorenz63_unet1d")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sdeflow_tpu_torch import build_msgm_arm, get_preset, make_sampler_fn
    from sdeflow_tpu_torch.experiments.driver import make_model
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.kernels.attnblock import (
        K3, _launch, attn_block_math, fused_attention_block)
    from sdeflow_tpu_torch.ops.kernels.circulant import K1, K2, K2_SOLVE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "phase_start_s": {}}
    start = time.perf_counter()

    def phase(label):  # seconds from the build's start to each phase
        record["phase_start_s"][label] = time.perf_counter() - start

    phase("1")
    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    common.build_all()
    record["build_s"] = time.perf_counter() - t0
    log(f"kernels built in {record['build_s']:.1f} s: {sorted(common.KERNELS)}")

    g = torch.Generator(device=dev).manual_seed(0)
    if opts.only == "gn":
        gn_timing(g, dev, record)
        write_record(opts.record, record)
        return 0
    if opts.only == "driver":
        record["driver"] = check_driver(g, dev, card)
        write_record(opts.record, record)
        return 0
    if opts.only == "k7":
        k7_timing(g, dev, record)
        write_record(opts.record, record)
        return 0
    if opts.only == "attn_bf16":
        attn_bf16_timing(g, dev, record)
        write_record(opts.record, record)
        return 0
    if opts.only == "bf16":
        mix = gn_mix(make_model(get_preset("grf16"), DIM,
                                "NormalizeLogRadius", device=dev), dev)
        record["bf16"] = check_bf16_kernels(g, dev, mix)
        record["production"] = check_production(g, dev, card)
        write_record(opts.record, record)
        return 0
    if opts.only == "unfused_bf16":
        for label, key, fn in bf16_unfused_phases(card):
            phase(label)
            record[key] = fn(g, dev)
        write_record(opts.record, record)
        return 0
    if opts.only == "samplers":
        record["samplers"] = check_samplers(g, dev, card)
        write_record(opts.record, record)
        return 0
    if opts.only == "core_dit":
        record["core_dit"] = check_core_dit(g, dev, card)
        write_record(opts.record, record)
        return 0
    if opts.only == "signal":
        record["signal"] = check_signal(g, dev, card)
        write_record(opts.record, record)
        return 0
    if opts.only == "plots":
        record["plots"] = check_plots(g, dev, card)
        write_record(opts.record, record)
        return 0
    job = ExportJob()  # phase 28's exports, in a process of their own
    if opts.only == "unet_export":
        job.start()
        record["unet_export"] = check_unet_export(g, dev, card, job)
        write_record(opts.record, record)
        return 0

    phase("2")
    # -- 2. K1 against its plain version ------------------------------------
    k1 = check_k1(g, dev)
    record["k1"] = k1

    phase("3")
    # -- 3. K3 against its plain version ------------------------------------
    k3 = {}
    with torch.no_grad():
        for b, t, c, heads in K3_SHAPES:
            args = block_args(g, dev, b, t, c)
            out = fused_attention_block(*args, 32, heads)
            torch.cuda.synchronize()
            ref = attn_block_math(*args, 32, heads)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
            err = (out - ref).abs().max().item()
            log(f"K3 ({b}, {t}, {c}) heads={heads}: "
                f"max |kernel - plain| = {err:.3g}")
            if heads == 1:
                bound = bound_ms(*k3_cost(b, t, c, heads))
                k3[(t, c)] = {
                    "shape": [b, t, c], "heads": heads, "max_abs_err": err,
                    "calls_per_forward": BLOCK_MIX[(t, c)],
                    "ms": cuda_ms(lambda: fused_attention_block(
                        *args, 32, heads)),
                    "plain_ms": cuda_ms(lambda: attn_block_math(
                        *args, 32, heads)),
                    "direct_ms": cuda_ms(lambda: _launch(*args, 32, heads)),
                    "bound_ms": bound[0], "bound_by": bound[1],
                }

    phase("4")
    # -- 4. the arm on both routes, and the GroupNorm shapes of a forward ----
    cfg = get_preset("grf16")
    if STEPS not in cfg.sweep.num_stepss_backward:
        raise AssertionError(f"{STEPS} steps is not a grf16 setting")
    t0 = time.perf_counter()
    model, gen = build_msgm_arm(cfg, g, device=dev)
    randomize_(model, g)
    with torch.no_grad():  # a gentler score head: |a| ~ 1 instead of ~10
        model.core.conv_out.weight.mul_(0.1)
    sample = make_sampler_fn(gen, N_SAMPLES, DIM, STEPS,
                             method=cfg.sweep.backward_method,
                             norm_correction=True, device=dev)
    torch.cuda.synchronize()
    record["setup_s"] = time.perf_counter() - t0
    cfg_u = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, attention_impl="unfused"))
    model_u = make_model(cfg_u, DIM, "NormalizeLogRadius", device=dev)
    model_u.load_state_dict(model.state_dict())
    gen_u = dataclasses.replace(gen, score_net=model_u)
    mixes = [gn_mix(model, dev), gn_mix(model_u, dev)]
    for route, mix in zip(("auto", "unfused"), mixes):
        n = sum(mix.values())
        if n != per_forward(route)["group_norm_silu"]:
            raise AssertionError(f"{route}: {n} GroupNorms per forward")
        log(f"{route} route: {n} GroupNorms per forward, (C, S, silu): "
            f"{dict(sorted(mix.items()))}")

    phase("5")
    # -- 5. K5 against its plain version ------------------------------------
    k5 = check_k5(g, dev, mixes)
    record["k5"] = k5

    phase("6")
    # -- 6. K6 and K4 against their plain version ----------------------------
    k6 = check_k6(g, dev)
    record["k6"] = {f"{t}x{c}": v for (t, c), v in k6.items()}

    job.start()  # after the kernels' timings, beside the paths

    phase("7")
    # -- 7. serve three requests on the main path ------------------------------
    want = serve_want("auto")
    requests = []
    for r in range(REQUESTS):
        noise = torch.randn(STEPS, N_SAMPLES, DIM, generator=g, device=dev)
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0 = gen.latent_sample(g, N_SAMPLES, DIM)
        x = sample(g, x0=x0, noise=noise)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        if not torch.isfinite(x).all() or tuple(x.shape) != (N_SAMPLES, DIM):
            raise AssertionError(f"request {r}: bad samples {tuple(x.shape)}")
        torch.testing.assert_close(x.norm(dim=1), x0.norm(dim=1), rtol=1e-5,
                                   atol=0)
        if launches != want:
            raise AssertionError(f"request {r}: launches {launches} != {want}")
        if (x - x0).abs().max().item() < 0.1:
            raise AssertionError(f"request {r}: the solve did not move x0")
        requests.append({"ms": dt * 1e3, "samples_per_s": N_SAMPLES / dt,
                         "launches": launches})
        log(f"request {r}: {dt * 1e3:.1f} ms, {N_SAMPLES / dt:.1f} samples/s,"
            f" launches {launches}")
    record["requests"] = requests

    phase("8")
    # -- 8. replay the last request: plain, (kernel, direct, direct, kernel)
    # twice, plain; the plain runs swap the kernel wrappers for their plain
    # versions where the path calls them, the direct runs for launches
    # without the autograd.Function; the mirrored order keeps drift out of
    # the comparison
    record["replay"] = serve_runs(
        sample, g, x0, noise, x,
        ("plain", *("kernel", "direct", "direct", "kernel") * 2, "plain"),
        want)

    phase("9")
    # -- 9. where one request's time goes: a torch.profiler trace -------------
    sample2 = make_sampler_fn(gen, N_SAMPLES, DIM, PROFILED_STEPS,
                              method="rk4", norm_correction=True, device=dev)
    prof = dict(trace(lambda: sample2(g)), steps=PROFILED_STEPS)
    record["profile"] = prof
    log_trace(f"{PROFILED_STEPS} RK4 steps", prof)

    phase("10")
    # -- 10. the unfused route's serving ---------------------------------------
    unfused = {"serve": serve_unfused(cfg, gen_u, g, dev, x0, noise, x,
                                      sample)}
    record["unfused"] = unfused

    phase("11")
    # -- 11. K4 on the unfused block at T = 4096 ------------------------------
    long = check_long_attention(g, dev)
    record["long_attention"] = long

    phase("12")
    # -- 12. K2 and its solve against their plain versions -------------------
    k2, solve = check_k2(gen, g, dev)
    record["k2"], record["k2_solve"] = k2, solve

    phase("13")
    # -- 13. autograd through the kernels -------------------------------------
    record["autograd"] = check_autograd(g, dev)

    phase("14")
    # -- 14. training at full width ------------------------------------------
    train, step = check_training(cfg, model, gen, g, dev)
    record["train"] = train
    record["trajectory"] = check_trajectory(gen, g, dev)

    phase("15")
    # -- 15. where one train step's time goes ---------------------------------
    prof_train = trace(step)
    record["train_profile"] = prof_train
    log_trace("one train step", prof_train)
    with plain_path():
        prof_plain = trace(step)
    record["train_profile_plain"] = prof_plain
    log_trace("one plain train step", prof_plain)

    phase("16")
    # -- 16. the unfused route's training ---------------------------------------
    unfused["train"] = train_unfused(cfg_u, model_u, gen_u, g, dev, step)

    phase("17")
    # -- 17. K7a and K7b against their plain versions ------------------------
    k7 = check_flash(g, dev)
    record["k7"] = k7

    phase("18, 19")
    # -- 18, 19. DSM training of the SGM arm at 128×128 ----------------------
    sgm = check_sgm_training(g, dev)
    record["sgm_train"] = sgm

    phase("20")
    # -- 20. the experiment driver on grf16, both arms -------------------------
    record["driver"] = check_driver(g, dev, card)
    drive = record["driver"]["launches"]

    phase("21")
    # -- 21. the bf16 variants of K5, K5b and K3 against their plain twins ---
    bf = check_bf16_kernels(g, dev, mixes[0])
    record["bf16"] = bf

    phase("22")
    # -- 22. the grf16_production preset through the CLI ----------------------
    prod = check_production(g, dev, card)
    record["production"] = prod
    prod_k = prod["launches"]

    # -- 23-25. bf16 on the unfused route: the kernels, the grf U-Net at
    # 128×128 (DSM training, a request), grf16_production through the CLI
    for label, key, fn in bf16_unfused_phases(
            card, sgm["max_memory_allocated"]):
        phase(label)
        record[key] = fn(g, dev)
    attn16, dsm16 = record["attention_bf16"], record["dsm_bf16"]
    prod_u = record["production_unfused"]

    phase("26")
    # -- 26. the PF-ODE and DPM-Solver samplers and the exact NLL (CLI) ------
    samplers = check_samplers(g, dev, card, requests[-1]["ms"])
    record["samplers"] = samplers

    phase("27")
    # -- 27. the DiT score nets and the core MLP path ------------------------
    core = check_core_dit(g, dev, card)
    record["core_dit"] = core

    phase("28")
    # -- 28. the rest of the U-Net (learned potential, remat, dims 1 and 3,
    # labels) and serving export ------------------------------------------
    unet_export = check_unet_export(g, dev, card, job)
    record["unet_export"] = unet_export

    phase("29")
    # -- 29. the signal regime: file-backed Lorenz-63 data, UNet1D, d = 1000 -
    signal = check_signal(g, dev, card)
    record["signal"] = signal

    phase("30")
    # -- 30. the plots and the profiling utilities: the CLI with its figures
    # on grf16 and lorenz63_unet1d (K2's single step in each MSGM noising
    # trajectory) -------------------------------------------------------
    plots = check_plots(g, dev, card, k1["ms"], drive)
    record["plots"] = plots

    phase("table")
    # -- the kernel table ----------------------------------------------------
    k3_rows = list(k3.values())
    k6_rows = [k6[s] for s in BLOCK_MIX]
    for r in k6_rows:
        r["calls_per_forward"] = BLOCK_MIX[(r["shape"][1], r["shape"][2])]
    k4 = k6[(K4_SHAPES[0][1], K4_SHAPES[0][2])]
    serve_k = requests[-1]["launches"]
    serve_u = unfused["serve"]["request"]["launches"]
    train_u = unfused["train"]["launches_per_step"]

    def mixed(rows, **extra):  # per launch, over the main path's mix
        keys = ("ms", "direct_ms", "plain_ms", "bound_ms")
        out = {k: weighted(rows, k) for k in keys}
        if "library_ms" in rows[0]:
            out["library_ms"] = weighted(rows, "library_ms")
        out["bound_by"] = ("operations" if all(
            r["bound_by"] == "operations" for r in rows) else "bytes")
        out["per_shape"] = rows
        return dict(out, **extra)

    kernels = [
        dict(k1, name=K1.name, id="K1", route="cuda",
             source="sdeflow_tpu_torch/csrc/circulant.cu",
             replaces="sdeflow_tpu/ops/pallas/circulant.py:47",
             launches=serve_k[K1.name], launches_per="serve request",
             library_ms=None,
             device_ms=prof["per_launch_ms"].get(SYMBOL[K1.name]),
             train_launches_per_step=train["launches_per_step"][K1.name],
             train_device_ms=prof_train["per_launch_ms"].get(
                 SYMBOL[K1.name])),
        dict(k2, name=K2.name, id="K2", route="cuda",
             source="sdeflow_tpu_torch/csrc/rk4.cu",
             replaces="sdeflow_tpu/ops/pallas/circulant.py:118",
             launches=record["trajectory"]["launches"][K2.name],
             launches_per="forward trajectory (sample_scheme_allt, batch "
             f"{TRAIN_BATCH}; 0 per SSM step)", library_ms=None,
             device_ms=k2["device_ms_alone"]),
        dict(solve, name=K2_SOLVE.name, id="K2 solve", route="cuda",
             source="sdeflow_tpu_torch/csrc/rk4.cu",
             replaces="sdeflow_tpu/ops/pallas/circulant.py:118 in the "
             "lax.scan of sdeflow_tpu/ops/integrators.py:232-243",
             launches=train["launches_per_step"][K2_SOLVE.name],
             launches_per="SSM train step", library_ms=None,
             train_device_ms=prof_train["per_launch_ms"].get(
                 SYMBOL[K2_SOLVE.name])),
        dict(mixed(k3_rows), name=K3.name, id="K3", route="cuda",
             source="sdeflow_tpu_torch/csrc/attnblock.cu",
             replaces="sdeflow_tpu/ops/pallas/attnblock.py:188",
             launches=serve_k[K3.name], launches_per="serve request",
             max_abs_err=max(r["max_abs_err"] for r in k3_rows),
             library_ms=None,
             device_ms=prof["per_launch_ms"].get(SYMBOL[K3.name]),
             train_launches_per_step=train["launches_per_step"][K3.name],
             train_device_ms=prof_train["per_launch_ms"].get(
                 SYMBOL[K3.name])),
        dict(mixed(k5["per_shape"]), name="group_norm_silu", id="K5",
             dsm_mix=dict(mixed(sgm["k5_dsm"]),
                          launches_per_step=sgm["launches_per_step"][
                              "group_norm_silu"]),
             route="cuda", source="sdeflow_tpu_torch/csrc/groupnorm.cu",
             replaces="sdeflow_tpu/ops/pallas/groupnorm.py:111",
             launches=serve_k["group_norm_silu"],
             launches_per="serve request (auto route)",
             launches_unfused=serve_u["group_norm_silu"],
             max_abs_err=k5["max_abs_err"],
             device_ms=prof["per_launch_ms"].get(SYMBOL["group_norm_silu"]),
             train_launches_per_step=train["launches_per_step"][
                 "group_norm_silu"],
             train_device_ms=prof_train["per_launch_ms"].get(
                 SYMBOL["group_norm_silu"])),
        dict(mixed(sgm["k5b_dsm"], old_ms=weighted(sgm["k5b_dsm"], "old_ms"),
                   grf16_mix=mixed(k5["bwd_per_shape"],
                                   old_ms=weighted(k5["bwd_per_shape"],
                                                   "old_ms"))),
             name="group_norm_silu_bwd", id="K5b", route="cuda",
             source="sdeflow_tpu_torch/csrc/groupnorm.cu",
             replaces="the backward of group_norm_silu (no Pallas kernel; "
             "the custom_jvp rule's transpose, "
             "sdeflow_tpu/ops/pallas/groupnorm.py:147-151)",
             launches=sgm["launches_per_step"]["group_norm_silu_bwd"],
             launches_per=f"DSM train step (grf U-Net, {SGM_NPIXEL}x"
             f"{SGM_NPIXEL}, batch {SGM_BATCH})",
             ssm_launches_per_step=train["launches_per_step"][
                 "group_norm_silu_bwd"],
             ssm_launches_per_step_unfused=train_u["group_norm_silu_bwd"],
             max_abs_err=k5["bwd_max_abs_err"],
             max_rel_err=k5["bwd_max_rel_err"],
             device_ms=sum(sgm["profile"]["per_launch_ms"].get(k, 0) for k in
                           ("gn_silu_bwd_kernel", "gn_silu_bwd_params")),
             device_ms_under_backward=sgm["profile"]["op_device_ms"].get(
                 "GroupNormSiLUBackward")),
        dict(mixed(k6_rows), name="qkv_attention", id="K6", route="cuda",
             dsm_shape=dict(k6[K6_DSM], launches_per_step=sgm[
                 "launches_per_step"]["qkv_attention"]),
             source="sdeflow_tpu_torch/csrc/attention.cu",
             replaces="sdeflow_tpu/ops/pallas/attention.py:225",
             launches=serve_u["qkv_attention"],
             launches_per="serve request (unfused route)",
             max_abs_err=max(r["max_abs_err"] for r in k6_rows),
             device_ms=unfused["serve"]["profile"]["per_launch_ms"].get(
                 SYMBOL["qkv_attention"]),
             train_launches_per_step=train_u["qkv_attention"],
             train_device_ms=unfused["train"]["profile"][
                 "per_launch_ms"].get(SYMBOL["qkv_attention"])),
        dict(k4, name="qkv_attention_flash", id="K4", route="cuda",
             source="sdeflow_tpu_torch/csrc/flash_fwd.cu",
             replaces="sdeflow_tpu/ops/pallas/attention.py:201",
             launches=long["launches"]["qkv_attention_flash"],
             launches_per="T = 4096 AttentionBlock: no-grad forward, jvp "
             "and grad (the jvp and grad take K7a/K7b)",
             device_ms=long["profile"]["per_launch_ms"].get(
                 SYMBOL["qkv_attention_flash"])),
        *[dict(k7[i], name=name, id=i, route="cuda",
               source=f"sdeflow_tpu_torch/csrc/{src}",
               replaces=f"sdeflow_tpu/ops/pallas/attention.py:{line}",
               launches=sgm["launches_per_step"][name],
               launches_per=f"DSM train step (grf U-Net, {SGM_NPIXEL}x"
               f"{SGM_NPIXEL}, batch {SGM_BATCH})",
               device_ms=sgm["profile"]["per_launch_ms"].get(SYMBOL[name]),
               device_shape=[SGM_BATCH, 4096, 64])
          for i, name, src, line in [
              ("K7a", "qkv_attention_stats", "flash_fwd.cu", 344),
              ("K7b", "qkv_attention_bwd", "attention_bwd.cu", 436)]],
    ]
    # the bf16 variants: launches in the production run (phase 22), which
    # launches no fp32 variant of K3, K5 or K5b
    bf16_of = {"fused_attention_block": "K3", "group_norm_silu": "K5",
               "group_norm_silu_bwd": "K5b"}
    req = prod["generate"]["MSGM"]["launches"]
    ssm = prod["train"]["SGM"]["launches_per_step"]

    def worst(key):  # phase 21's worst at grf16's mix and the DSM step's
        return max(bf["max_errs"][key], bf["max_errs"][f"dsm_{key}"])

    kernels += [
        dict(mixed(bf["k3"]), name="fused_attention_block_bf16",
             id="K3 bf16", counter="fused_attention_block",
             ssm_mix=mixed(bf["k3_ssm"]),
             max_abs_err=bf["max_errs"]["k3"], library_ms=None,
             source="sdeflow_tpu_torch/csrc/attnblock.cu",
             device_ms=prod["request_profile"]["per_launch_ms"].get(
                 SYMBOL_BF16["fused_attention_block"]),
             train_device_ms=prod["ssm_profile"]["per_launch_ms"].get(
                 SYMBOL_BF16["fused_attention_block"])),
        dict(mixed(bf["k5_grf16"]), name="group_norm_silu_bf16",
             id="K5 bf16", counter="group_norm_silu",
             ssm_mix=mixed(bf["k5_ssm"]), max_abs_err=worst("k5"),
             source="sdeflow_tpu_torch/csrc/groupnorm.cu",
             device_ms=prod["request_profile"]["per_launch_ms"].get(
                 SYMBOL_BF16["group_norm_silu"]),
             train_device_ms=prod["ssm_profile"]["per_launch_ms"].get(
                 SYMBOL_BF16["group_norm_silu"]),
             dsm_step_device_ms=dsm16["profile"]["ms_by_symbol"].get(
                 SYMBOL_BF16["group_norm_silu"], 0),
             dsm_launches_per_step=dsm16["launches_per_step"][
                 "group_norm_silu"]),
        dict(mixed(bf["k5b_ssm"], old_ms=weighted(bf["k5b_ssm"], "old_ms"),
                   grf16_mix=mixed(bf["k5b_grf16"])),
             name="group_norm_silu_bwd_bf16", id="K5b bf16",
             counter="group_norm_silu_bwd",
             max_abs_err=worst("k5b_dx"),
             max_rel_err_params=worst("k5b_params"),
             source="sdeflow_tpu_torch/csrc/groupnorm.cu",
             train_device_ms=sum(prod["ssm_profile"]["per_launch_ms"].get(
                 k, 0) for k in ("gn_silu_bwd_kernel", "gn_silu_bwd_params")),
             dsm_step_device_ms=sum(dsm16["profile"]["ms_by_symbol"].get(
                 k, 0) for k in ("gn_silu_bwd_kernel", "gn_silu_bwd_params")),
             dsm_launches_per_step=dsm16["launches_per_step"][
                 "group_norm_silu_bwd"]),
    ]
    for k in kernels[-3:]:
        c = k["counter"]
        k.update(route="cuda", launches=prod_k[c], driver_launches=0,
                 launches_per="production run (phase 22: both arms' 8 bf16 "
                 "SSM steps, ELBO prints and one request each)",
                 request_launches=req[c], ssm_launches_per_step=ssm[c],
                 replaces=next(r["replaces"] for r in kernels
                               if r["id"] == bf16_of[c]))
        k.setdefault("device_ms", None)
    for k in kernels[:-3]:  # this slice's path: the production run
        k["driver_launches"] = drive[k["name"]]
        k["production_launches"] = (0 if k["name"] in bf16_of
                                    else prod_k[k["name"]])
    # the bf16 variants of the unfused route's attention kernels: launches
    # on path (a) (phase 25's production run on the unfused route) and path
    # (b) (phase 24: per bf16 DSM step and in the reduced request); device
    # time from phase 24's traces
    entries = prod_u["entry_launches"]
    dsm_step = dsm16["launches_per_step"]
    dsm_req = dsm16["request"]["launches"]
    per_step_ms = dsm16["profile"]["per_launch_ms"]
    req_ms = dsm16["request_profile"]["per_launch_ms"]

    def by_shape(rows, shape):
        return next(r for r in rows if r["shape"] == list(shape))

    k6_mix, k6_ssm = ([dict(r, calls_per_forward=BLOCK_MIX[tuple(
        r["shape"][1:])]) for r in attn16["k6"] if r["shape"][0] == b
        and tuple(r["shape"][1:]) in BLOCK_MIX] for b in (N_SAMPLES,
                                                          TRAIN_BATCH))
    long_rows = {k: (by_shape(attn16[k], ATTN_BF16_LONG[0]),
                     by_shape(attn16[k], ATTN_BF16_LONG[1]))
                 for k in ("k4", "k7a", "k7b")}
    errs16 = attn16["max_errs"]
    kernels += [
        dict(mixed(k6_mix), name="qkv_attention_bf16", id="K6 bf16",
             counter="qkv_attention", ssm_mix=mixed(k6_ssm),
             dsm_shape=dict(by_shape(attn16["k6"], K6_BF16_DSM),
                            launches_per_step=dsm_step["qkv_attention"],
                            device_ms=per_step_ms.get(
                                SYMBOL_BF16["qkv_attention"])),
             max_abs_err=errs16["K6"], source="sdeflow_tpu_torch/csrc/"
             "attention.cu", launches=entries["qkv_attention_bf16"],
             launches_per="grf16_production run on the unfused route "
             "(phase 25: both arms' 8 bf16 SSM steps, ELBO prints and one "
             "request each)",
             dsm_launches_per_step=dsm_step["qkv_attention"],
             dsm_request_launches=dsm_req["qkv_attention"],
             device_ms=req_ms.get(SYMBOL_BF16["qkv_attention"]),
             unfused_request_device_ms=prod_u["request_profile"][
                 "per_launch_ms"].get(SYMBOL_BF16["qkv_attention"])),
        dict(long_rows["k4"][0], name="qkv_attention_flash_bf16",
             id="K4 bf16", counter="qkv_attention_flash",
             dsm_shape=long_rows["k4"][1], max_abs_err=errs16["K4"],
             source="sdeflow_tpu_torch/csrc/flash_fwd.cu",
             launches=dsm_req["qkv_attention_flash"],
             launches_per=f"bf16 request of the grf U-Net at {SGM_NPIXEL}x"
             f"{SGM_NPIXEL} (phase 24: {DSM_BF16_REQUEST} samples, "
             f"{DSM_BF16_STEPS} EM steps and one corrector step each)",
             device_ms=req_ms.get(SYMBOL_BF16["qkv_attention_flash"])),
        *[dict(long_rows[key][0], name=f"{name}_bf16", id=f"{i} bf16",
               counter=name, dsm_shape=long_rows[key][1],
               max_abs_err=errs16[i], source=f"sdeflow_tpu_torch/csrc/{src}",
               launches=dsm_step[name],
               launches_per=f"bf16 DSM train step (grf U-Net, {SGM_NPIXEL}"
               f"x{SGM_NPIXEL}, batch {SGM_BATCH}; phase 24)",
               device_ms=sum(per_step_ms.get(sym, 0) for sym in syms),
               device_shape=[SGM_BATCH, 4096, 64])
          for i, key, name, src, syms in [
              ("K7a", "k7a", "qkv_attention_stats", "flash_fwd.cu",
               [SYMBOL_BF16["qkv_attention_stats"]]),
              ("K7b", "k7b", "qkv_attention_bwd", "attention_bwd.cu",
               [SYMBOL_BF16["qkv_attention_bwd"], K7B_BF16_DQ])]],
    ]
    k7a16 = kernels[-2]
    k7a16["lse_max_abs_err"] = errs16["K7a_lse"]
    for k in kernels[-4:]:
        k.update(route="cuda", driver_launches=0, production_launches=0,
                 unfused_production_launches=entries[k["name"]],
                 replaces=next(r["replaces"] for r in kernels
                               if r["id"] == k["id"].split()[0]))
    for k in kernels:  # phase 26 runs fp32 only (grf16's compute dtype)
        k["samplers_launches"] = (0 if "counter" in k
                                  else samplers["launches"][k["name"]])
        # phase 27's two DiT runs launch K1 and K2's solve, fp32 entries
        k["core_dit_launches"] = (0 if "counter" in k
                                  else core["launches"][k["name"]])
        # phase 28's runs, by entry point (fp32 and bf16 apart)
        kernel = k.get("counter", k["name"])
        k["unet_export_launches"] = unet_export["entry_launches"].get(
            f"{ENTRY[kernel]}_{'bf16' if 'counter' in k else 'f32'}", 0)
        # phase 29's CLI runs launch K1 and K2's solve, fp32 entries
        k["signal_launches"] = (0 if "counter" in k
                                else signal["launches"][k["name"]])
        # phase 30's CLI runs with figures: phase 20's and 29's launches
        # and K2's single step in each MSGM noising trajectory
        k["plots_launches"] = (0 if "counter" in k
                               else plots["launches"][k["name"]])
    # K1, K2 and K2's solve at d = 1000 (their general plans), phase 29
    for k in kernels[:3]:
        if k["id"] == "K2 solve":
            k["signal_d1000"] = dict(signal["solve"],
                                     launches=signal["launches"][k["name"]])
        else:
            k["signal_d1000"] = {
                shape: rows[k["name"]] for shape, rows in signal["k"].items()}
            k["signal_d1000"]["launches"] = signal["launches"][k["name"]]
    for k in kernels:
        missing = {"name", "route", "source", "replaces", "launches",
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms"} - set(k)
        if missing:
            raise AssertionError(f"{k['id']} lacks {sorted(missing)}")
        lib = ("no single PyTorch call computes it" if k["library_ms"] is None
               else f"library call {k['library_ms']:.4f} ms")
        log(f"{k['id']} {k['name']}: {k['ms']:.4f} ms per call (direct "
            f"launch {k['direct_ms']:.4f} ms, device {k['device_ms']} ms), "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), plain version "
            f"{k['plain_ms']:.4f} ms; {lib}; {k['launches']} launches per "
            f"{k['launches_per']}; {k['driver_launches']} in the driver's "
            f"run, {k['samplers_launches']} in phase 26's, "
            f"{k['core_dit_launches']} in phase 27's, "
            f"{k['unet_export_launches']} in phase 28's, "
            f"{k['signal_launches']} in phase 29's, "
            f"{k['plots_launches']} in phase 30's")
    record["kernels"] = kernels
    phase("end")
    log("phases start at (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in record["phase_start_s"].items()))
    write_record(opts.record, record)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
