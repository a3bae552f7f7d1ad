"""Smoke run of tramp_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and no result
line is printed):
1. the device: a CUDA device must be present; prints nvidia-smi's name and
   power limit;
2. builds the CUDA kernels (tramp_tpu_torch/csrc/pl_posterior.cu and
   pl_message.cu, one nvcc per source and floating type, all at once) from
   the checkout and prints the seconds taken and ptxas's registers and
   spills per instantiation; an instantiation with at most three regions
   (all the repo's channels) must not spill;
3. holds every kernel against its plain PyTorch version on the card for the
   six piecewise-linear channels of tests/test_pallas_ops.py, at n = 2048
   and n = 2**20 + 300, in float64 (rtol 1e-10, as the JAX package's Pallas
   test) and float32 (rtol 1e-4), relative to each element with a floor of
   rtol times the stream's largest magnitude: the five-output posterior
   kernel with CUDA-event times per call of both, and the forward and
   backward message kernels on a_new and b_new, also with per-element
   precisions, with n = 1 and with an n that is no multiple of 4; with
   lanes, every layout of the message kernels (one block per lane up to
   4096 elements, one cluster per lane, two launches) at 2, 3 and 257
   lanes, for two and three regions and a channel of four, each lane
   against its single launch (the same bits). Then, at
   the main path's case (relu, n = 2048, float32) and in turns (old, new,
   new, old), the composition the sweep ran before the fusion (five-output
   kernel, torch.mean, compute_ab_new) against the fused message: time per
   call (CUDA events), host time per call (unsynchronised calls on the
   host's clock) and kernels launched, beside an empty kernel's launch; and
   each kernel's device time from torch.profiler beside its bound; then
   the Gauss-Bernoulli prior's kernel (tramp_tpu_torch/csrc/gb_prior.cu,
   built on its own, no spill): ``gb_posterior`` and ``gb_message``
   against their plain versions at 2048 lanes of 4096 and of 10,000 and
   one instance of 4096, float32 and float64, at the tolerances of
   tests/test_torch_gb_prior_kernel.py, one launch a call, each with its
   device time, time per call, host time, byte bound and the plain
   version's device time; the paths of phases 4 to 7 that run it (the
   engine's relu nets and flagship, the front door's flagship and relu
   net) must launch it once per sweep (the message) or once per
   iteration and readout (the GLM's posterior); then ML-VAMP's loop
   finish (tramp_tpu_torch/csrc/ml_vamp_finish.cu, both types built, no
   spill) against its plain version on the relu
   net's loop state three iterations in, at 2048 lanes in float64 and
   float32 (every third lane frozen) and at one instance in float64:
   carry, metric, flags, ok and converged bit for bit, delta within 4
   ulps, one launch a call, with the device time, time per call, host
   time, byte bound and the plain version's device time; phase 7's
   MLVAMPSolver solves must launch it once per loop iteration, its
   EPSolver solves never;
4. the EP engine's main path through the kernels: the relu net
   x -> W -> relu -> + noise -> y at N = 4096, alpha = 0.5, rho = 0.25,
   noise 1e-2 (bench.py:1124-1157), solved with
   ``ExpectationPropagation(student).iterate(max_iter=500, damping=0.1,
   tol=1e-6)`` in float32 and float64 on the card (a warm-up solve, then a
   timed one). It checks that each message kernel ran once per sweep and
   the five-output kernel not at all, that the outputs are finite, and that
   float32 and float64 agree on the posterior variance and the MSE within
   5e-2 (bench.py:118-119); reads the relu factor's two posteriors at the
   fixed point through the five-output kernel; counts the kernels of a warm
   sweep and the device's busy share with torch.profiler, with the fused
   messages and, in turns, with the composition they replace; and, at N = 256
   in float64, checks that the card's solve matches the CPU's (plain
   versions) in n_iter and, at rtol 1e-8, in the x posterior, and that two
   solves on the card give the same bits;
5. the flagship compressed-sensing GLM at N = 10**4, alpha = 0.5, float32
   (no kernel on this path), with |mse - v| / v < 0.25, the finite-N band
   of __graft_entry__.py:126;
6. the flagship through the front door: ``dispatch_solver(student)`` must
   give a SpectralVAMPSolver; one solve (converged, inside the band, x's
   posterior v within 1e-2 of phase 5's); then ``solve_batch`` over 2048
   lanes that share W and have an observation each, drawn on the card from
   the teacher: every lane converged, three lanes within 1e-3 of the largest
   |r| of their single solves and within 2 iterations; iterations, seconds,
   lane-iterations per second, peak memory, and per iteration the kernels,
   device time, wall time, busy share and the five device operations that
   took most time (torch.profiler over a run of 10 iterations less a run of
   none, which leaves the set-up and the readout out);
7. the relu net through the front door: ``dispatch_solver(student,
   damping=0.1, max_iter=500, tol=1e-6)`` must give an MLVAMPSolver; one
   solve in float32 and float64 (f32 against f64 within 5e-2 in v and MSE,
   f64 within 1e-3 of the largest |r| of phase 4's fixed point), then
   ``solve_batch`` over 2048 lanes in float32 and ``EPSolver.solve_batch``
   over the same lanes, with exactly one launch of each message kernel per
   sweep and none of the five-output kernel, which then reads the relu
   factor's posteriors for all lanes in two launches; the same readings as
   in phase 6. With 2048 lanes on one W the float32 stop metric has a
   rounding floor above the single solve's tolerance (the script reads it;
   chip_stop_floor.py traces it to the float32 GEMM), so the batch is
   solved twice: at tol 1e-5, where every lane must converge
   and three lanes are held against their single solves, and at the single
   solve's 1e-6, where the count of converged lanes is only printed;
8. a JSON line on the kernels (``pl_posterior``'s row carries the
   adaptive EP sweep's launches, device ms and bound under
   ``adaptive_ep_sweep``; ``gb_posterior``'s and ``gb_message``'s rows
   their launches on phases 4 to 7 and phase 3's readings;
   ``ml_vamp_finish``'s its launches on phase 7 and phase 3's readings),
   then the
   result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
9. (run before the summary) the state evolution, all in float64:
   a. the compressed-sensing golden rows of tests/test_golden_csv.py through
      ``StateEvolution(glm_state_evolution(...)).iterate`` on the card;
   b. the phase grid at the repo's own width (bench.py:742-754): alpha =
      linspace(0.02, 2, 100) plus the golden alphas, rho = linspace(0.05,
      0.95, 10), 1030 lanes in one ``SESolver.solve_batch`` through
      ``se_phase_grid_records`` (``run_se_phase_grid`` without pandas): every
      v finite, the golden rows inside their tolerances, lanes 0, middle and
      last equal to their single solves (v to rtol 1e-10, equal n_iter);
      seconds, points/s, and per iteration the kernels, the device time and
      the busy share; then the 19 critical lines of that test file through
      ``find_critical_alpha_batched``, within alpha_tol = 1e-3 of the pinned
      values, with the count of bit-equal lines;
   c. the five-output kernel as the SE integrand: ``StateEvolution`` of the
      relu-net student of phase 4 (float64) on the card against the same on
      the CPU with the plain version (equal n_iter, v of x, z, a to rtol
      1e-8), with exactly 2 launches of ``pl_posterior`` per sweep, none of
      the message kernels and no call of the region-by-region path or the
      plain version; then prior -> Marchenko-Pastur -> relu -> Gaussian
      likelihood over alpha = linspace(0.1, 2, 64) x rho = linspace(0.05,
      0.95, 16), 1024 lanes in one solve_batch: every v finite, 2 launches
      per iteration, three lanes equal to their single solves (rtol 1e-8), a
      profiled window with the five operations that take most time, peak
      memory. Phase 3 holds the kernel against its plain version at this
      shape, (1024, 20000) float64, and times it beside its bound;
   d. EP against SE on one instance: the flagship's |v_EP - v_SE| / v_SE
      < 0.25; the relu net's v_SE, v_EP and MSE are printed.
10. (run before the summary) the priors and likelihoods of ROADMAP Queue 1
    item 3, none of which reaches a kernel (every path's launches are
    checked to be 0 and listed in the kernels line):
   a. the 27 golden SE rows of tests/test_golden_csv.py that need them
      (relu, sign retrieval, door, phase retrieval, perceptron, phase
      retrieval EP-vs-SE), float64, within that file's tolerances (copied
      below); each family one ``SESolver.solve_batch`` with its rows as
      lanes (alpha, rho, p_pos per lane, a0 per lane through the list of
      initializers; the door's EarlyStopping(max_increase=0.1) as
      ``rollback_increase``, the EP-vs-SE rows' damping and
      EarlyStopping(wait_increase=10) as the solver's), and one lane per
      family against the golden test's own call, ``StateEvolution.iterate``
      with its callback (v to rtol 1e-10, equal n_iter);
   b. the relu (4 lines), sign-retrieval (2 x 2) and door critical lines
      through ``find_critical_alpha_batched``, within alpha_tol = 1e-3 of
      the pinned values, with the count of bit-equal lines and each
      family's seconds;
   c. the perceptron of bench.py:504-533 (N = 1000, alpha = 1, p_pos = 0.25,
      RandomState(21)) through ``EPSolver`` and ``dispatch_solver`` (an
      MLVAMPSolver) in float32 and float64: f32 against f64 within 5e-2 in v
      and MSE, |v_EP - v_SE| / v_SE < 0.25 against the alpha = 1 golden
      lane of part a; then 2048 lanes on one W, a teacher and observation
      each, in float32 at tol 1e-5 through both solvers: every lane
      converged, three lanes of the MLVAMPSolver batch against their single
      solves (r within 1e-3 of the largest |r|, n_iter within 2), with the
      readings of phase 7;
   d. sign retrieval (abs output, alpha = 1.2) and the relu GLM (alpha =
      1.34) at rho = 0.4, N = 4096, float64, built by ``glm_generative``
      and observed through ``channel2likelihood``: EP from an informed start
      (a0 = 1000 on x) beside SE from a0 = 1000, with a profiled sweep
      window (readings, no limit);
   e. the perceptron at N = 256 in float64 through ``EPSolver`` on the card
      and on the CPU: equal n_iter, r and v to rtol 1e-8 (card_against_cpu:
      element by element, a mean's scale floored at 1, a value not finite
      fails); two card solves with the same bits.
11. (run before the summary) the complex channels and the trees of ROADMAP
    Queue 1 items 4a and 4b:
   a. phase retrieval, BASELINE config 2's second half (bench.py:573-618:
      N = 500, alpha 2, Gauss-Bernoulli rho 0.5 mean 0.01, RandomState(5),
      complex Gaussian F) through ``EPSolver(damping=0.3, max_iter=500,
      tol=1e-12, wait_increase=20, stop_kind="v")`` in float32 and float64
      with bench.py:120-128's bounds (converged; v f32 <= 1e-9; the
      phase-symmetric MSE f32 vs f64 within 5e-2; n_iter f32 at most twice
      f64's), no kernel launched, a profiled loop window; N = 128 float64
      on the card against the CPU (equal n_iter, r and v rtol 1e-8);
   b. 512 lanes of it on one F, float32, a teacher and y per lane: three
      lanes against their single solves (1e-3 of the largest |r|, n_iter
      within 2), lane-iterations/s, converged lanes, busy share, peak
      memory, the top device operations and the Bessel kernels' share;
   c. EP on ``glm_generative(output_type="modulus")`` at N = 2000, float64,
      at the PR_EP_VS_SE_ROWS alphas against their pinned SE values:
      |v_EP - v_SE| / v_SE < 0.25; and two-layer phase retrieval with the
      modulus channel mid-graph (tests/test_modulus_channel.py:125-157, N =
      1000): phase-symmetric MSE under half the signal power, a profiled
      sweep and the modulus channel's share of it;
   d. the soft committee (tests/test_models_misc.py:22-34: K = 2, N =
      2000, alpha 1.5, prior means 0.1 and -0.2, noise 1e-2) in float32
      through ``dispatch_solver``, which must give an EPSolver: finite r,
      0 < v < 1.5 for x_0 and x_1, exactly one forward and one backward
      relu launch per expert per sweep; the relu factors read out through
      ``pl_posterior`` and all three kernels held against their plain
      versions at the final state; N = 256 float64 on the card against the
      CPU; 512 lanes with a y each (three lanes against single solves);
      then, past the learning transition (alpha 8, damping 0.5, max_iter
      300), one solve with each expert's MSE under 5e-2 and 512 lanes as
      readings of a solve that converges;
   e. ``MultiLayerModel([GaussBernoulliPrior(rho=0.5), AbsChannel(),
      GaussianChannel(var=1e-2)])`` at N = 4096, float32: MSE of t_1 under
      5e-2, one abs message of each side per sweep, the readout and the
      kernels against their plain versions;
   f. the VAE prior, BASELINE config 4's protocol (bench.py:625-684) with
      the synthetic decoder of tests/test_vae_prior.py:20-27, the 25%
      middle band erased, ``EPSolver(damping=0.5, max_iter=300,
      rollback_increase=inf)`` from NoisyInit(seed=3), float32 and float64:
      the band MSE beside the fill-zero MSE, 2 forward and 2 backward
      messages per sweep, the readout and the kernels against their plain
      versions, and a 30-sweep float64 snapshot on the card against the
      CPU (rtol 1e-8; EP on this model has no fixed point);
   g. ``StateEvolution`` of the soft committee (N = 256, float64) on the
      card against the CPU: equal n_iter, every v to rtol 1e-10.
   Each of d, e and f must launch every kernel. If phase 11 passes 150 s
   before d, the committee's batch is cut to 256 lanes.
12. (run before the summary) item 3's priors, likelihoods and analytic
    channels that no earlier phase runs on the card, float64: one EP solve
    (card against CPU, equal n_iter, r and v rtol 1e-8) and one SE solve of
    each that the JAX package defines, through ``glm_generative`` /
    ``glm_state_evolution`` where those build the factor. The analytic abs
    channel's prior has mean 1 (from b = 0 a mean-0 prior leaves EP at
    r = 0). The L21 prior is solved as a denoiser and in a GLM, its (N, 2)
    variable through a dense LinearChannel (W @ Z). The committee-binary
    prior takes a K x K precision, which the EP engine does not pass: its
    denoiser's posterior and log-partition, exact in one step, are held
    card against CPU.
13. (run before the summary) the structured real channels, total
    variation, the low-rank family and the tanh channel (ROADMAP Queue 1
    items 4c, 6 and 7's tanh), none of which reaches a piecewise-linear
    kernel (each path's launches are 0 and listed in the kernels line):
   a. BASELINE config 3, the sparse gradient of bench.py:536-570 (N = 400,
      rho 0.04, noise 1e-2) through ``EPSolver(damping=0.1, tol=1e-6,
      max_iter=1000)`` in float32 and float64: v and MSE f32 against f64
      within 5e-2 (bench.py:114-115), a profiled loop window, float64 on
      the card against the CPU;
   b. the sparse-gradient regression tree at bench_tree_carry's size (N =
      2048, M = 1024, rho 0.05), 256 lanes on one A with a teacher and y
      each, float32, through ``EPSolver.solve_batch``: three lanes against
      their single solves (1e-3 of the largest |r|, n_iter within 2) and
      the readings of phase 7;
   c. 64 x 64 images, float64: the denoising example with the 2-D
      GradientChannel and a sparse-gradient or TV (L21) prior (mse under
      noise / (1 + noise)), the deconvolution example through
      Blur2DChannel (mse under the blurred observation's), and
      ``tv_regression`` (16 x 16) through EPSolver, card against CPU;
   d. the low-rank Delta sweep of bench.py:1393-1480 (M = N = 512, K = 2,
      16 seeds x 5 Deltas, float32 with TF32 off, one batched solve of 16
      lanes per Delta): dev = |mse_x - pred| / (3 sd + 0.1 pred) at most 1
      at every Delta, pred from ``se_matrix_factorization_kk(damping=0.5)``;
      instances/s; one iteration of the solver's loop under
      torch.profiler; then in float64 run to tol 1e-12 (at the bench's tol
      the chaotic first iterations leave the fixed point 1e-3 off), two of
      4 lanes against their single solves and M = N = 128 card against CPU
      (rtol 1e-8);
   e. ``LowRankFactorization`` and ``LowRankGramChannel`` inside the EP
      engine at tests/test_low_rank_activation.py:326-388's protocol, 512
      wide, float32: mse_x < 0.25 tau_x, the embedded solves' iterations
      per sweep;
   f. ``TanhChannel`` in place of the relu net's relu (N = 4096): f32
      against f64 within 5e-2 in v and MSE; N = 256 float64 card against
      CPU.

14. (run before the summary) the engine extras and the tooling of ROADMAP
    Queue 1 item 7, on the relu net of phase 4:
   a. ``iterate(damping="adaptive")`` (Bethe backtracking) at N = 4096 in
      float32 and float64, 8 sweeps: exactly 1 launch of each message and
      22 of ``pl_posterior`` per sweep after the undamped first (the relu
      factor's log-partition scores the old message and 10 candidates of
      each of the two writes into it); the loop without callback and the
      callback loop reach the same bits; the Bethe objective does not fall
      from the second sweep on by more than 1e-4 (f32) or 1e-10 (f64) of
      its largest magnitude; one adaptive sweep beside a ``damping=0.1``
      one under torch.profiler (kernels, device ms, wall ms, busy share,
      ``pl_posterior``'s device ms); at N = 256 in float64 the card against
      the CPU, with the count of accept decisions that differ (r and v at
      rtol 1e-8, 1e-6 where a decision differs);
   b. adaptive ``StateEvolution`` of the relu-net student in float64, card
      against CPU: equal n_iter, v within rtol 1e-8, exactly 2 + 22
      launches of ``pl_posterior`` per sweep after the first, the card's
      wall time (the CPU's run not in it); one warm adaptive sweep: the
      objectives it scores by node type, its calls of the engine's
      ``_prepare`` (the model's second moments) and their host time, and
      the sweep under torch.profiler (kernels, device ms, wall ms);
   c. ``iterate(update_dA=True)``: ``dA`` of every slot, finite, 4 launches
      of ``pl_posterior`` per sweep; at N = 256 in float64 equal to the
      CPU's within rtol 1e-8 of |dA| plus the largest;
   d. ``run_trace`` of 50 sweeps in float32 and float64: the v curves of a
      ``TrackEvolution`` callback within rtol 1e-5 / 1e-10, one host read
      (torch's sync debug mode), one launch of each message per sweep, and
      its time per sweep beside ``iterate(tol=0)``'s;
   e. ``save_state`` after 10 sweeps, ``load_state`` into a fresh engine and
      10 more sweeps: the bits of 20 sweeps; a checkpoint written on the
      CPU (N = 256, float64) resumed on the card against the CPU's
      continuation (as phase 4); ``solve_batch_with_state`` of
      ``MLVAMPSolver`` and ``EPSolver`` at 2048 lanes interrupted after 5
      iterations, ``save_checkpoint`` / ``restore_checkpoint`` and the
      rest: every lane's r, v and n_iter equal to the solve that was not
      interrupted;
   f. ``check_prior_grad_EP``, ``check_likelihood_grad_EP`` and
      ``check_belief_grad_b`` on the card in float64 (the autograd
      Functions of utils/special.py on CUDA), equal to the CPU's within
      rtol 1e-10;
   g. ``ExplainMessagePassing``, one sweep of a relu net with N = 64 on the
      card: the CPU's lines (the first 20 printed) and one launch of each
      message.

15. (run before the summary) the device mesh of ROADMAP Queue 1 item 5
    (``parallel.mesh``) on a world of one nccl rank, ``make_mesh((1, 1))``:
    the stop test's all_reduce and a posterior's all_gather timed beside
    the host read and a copy;
   a. the relu net of phase 7 (LANES lanes on one W, float32, tol
      BATCH_TOL) through ``shard_batched_model`` + ``EPSolver.solve_batch``,
      ``solve_batch_shard_map`` and ``dispatch_solver``'s
      ``MLVAMPSolver.solve_batch``: every lane's r, v and n_iter equal to
      the same solver's unsharded ``solve_batch``, one launch of each
      message kernel per iteration, time and busy share beside the
      unsharded solve's;
   b. phase 6's flagship batch through ``SpectralVAMPSolver.solve_batch`` on
      the mesh: the unsharded bits, no kernel, the operator bytes on the
      rank (the whole: a model axis of 1);
   c. phase 9b's 1030-point grid through ``se_phase_grid_records`` on a
      (1,) data mesh: every record equal to the grid without a mesh;
      ``save_grid_csv`` writes its 1031 lines;
   d. phase 14e's EPSolver checkpoint on the mesh: cut after 5 iterations,
      saved from the rank's lanes (``shard_batched_state``), restored
      through a sharded template, resumed: the uncut solve's bits;
   e. two nccl ranks on the one card (what NCCL prints is a reading), and
      a gloo world of 2 on the CPU, labelled so: the relu net at N = 256, 8
      lanes, float64, on (2, 1) and (1, 2) meshes against the same solves
      in one process (the same bits on the data axis; rtol 1e-6, atol 1e-8
      for EP and rtol 1e-10, atol 1e-13 with equal n_iter for ML-VAMP on
      the model axis, the JAX tests' tolerances).

16. (run before the summary) the reduced-precision throughput mode of
    ROADMAP Queue 1 item 8, each A/B pair in turns in this process:
   a. ``LinearChannel._mm`` with bfloat16 operands (``torch.mm`` /
      ``torch.bmm`` with ``out_dtype=torch.float32``) in every layout at the
      flagship's V (10^4 x 5000; LANES lanes; 4 operators per lane) against
      its plain form: each element within 1e-4 of |A_bf16| @ |x_bf16|, a
      float32 result; times beside the float32 product's and the bound;
   b. the flagship's LANES lanes through ``SpectralVAMPSolver.solve_batch``
      and ``EPSolver(stop_kind="v").solve_batch``, ``MATVEC_BF16`` off and
      on: per iteration wall, device ms, busy share, iterations, peak
      memory; each lane's mean v within 5e-2 of the float32 solve's
      (bench.py:118-119), |mse - v| / v over the lanes within phase 5's
      band;
   c. bench_gated's protocol (bench.py:336-467) at LANES lanes, A (float32,
      one phase) against B (``solve_batch_gated_bf16``'s two phases): its
      fields for stop kind "v" at tol 1e-6 (bench_gated's) and for stop
      kind "r" at BATCH_TOL, where v_rel_err_vs_f32 < 1e-3
      (tests/test_parallel.py:305); the coarse stop fired and B's polish
      converged on every lane in both;
   d. the relu net's LANES lanes (tol BATCH_TOL) through
      ``solve_batch_gated_bf16`` and one instance through
      ``solve_gated_bf16``: one launch of each message kernel per loop
      iteration in both phases, every lane converged, mean v within 1e-3
      of the float32 solve;
   e. ``PIN_CONSTANT_MESSAGES`` on the flagship, one instance, through the
      engine: the JAX package's pinned slots, r within rtol 1e-4, atol 1e-9
      of the unpinned solve in float64 (both to tol 1e-10), and float32
      sweeps pinned against unpinned.

17. (run before the summary) the gallery, tramp_tpu_torch/examples, through
    the scripts' ``main()`` on the card (outputs under build/phase17/),
    each path's launches counted from 0:
   a. compressed_sensing and perceptron at their default sizes: every v_SE
      against the JAX package's committed CSVs (examples/glm/output/, rtol
      1e-8), the EP columns finite and printed; phase_diagram_sweep's 96
      points on a one-rank nccl mesh against the committed
      phase_diagram.csv; matrix_factorization's mse_x_se against its
      committed CSV, and the committed and the card's mse_x_emp within 3.3
      sd of 12 solves of the same instances with the input perturbed by
      1e-13 (the solve is chaotic; the 12 solves are the lanes of one
      call of the solver);
   b. critical_alpha_door: both critical alphas within alpha_tol = 1e-3 of
      0.46214599609375 and 2.24278564453125, and the line over p_pos, the
      script's three searches as the five lanes of one batched bisection;
   c. the JMLR protocols at full width (N = 2000, 25 seeds as the lanes of
      one EPSolver.solve_batch per alpha; JMLR_EP_POINTS names the alphas):
      each point's mean within 3.3 sd / sqrt(25) + 0.05 v_SE + 1e-6 of
      v_SE (the seeds' standard error and the golden test's finite-N
      allowance), except at sparse phase retrieval's alpha 0.81 and 1.2,
      where SE lies below the symmetric point and EP, as in the JAX
      protocol, stops near it: there at least 4 lanes in 5 hold mse >
      mean(x**2) / 2 and three converged lanes are held against the CPU; the time of the 25 students (their
      SVDs) beside the solve's; the SE and BO curves at the --big point
      counts (readings), and at the default grid against the CPU (rtol
      1e-8);
   d. phase_diagram_sweep --big, 1000 points, its points/s;
   e. fast_paths: the dispatched classes, one launch of each message kernel
      per MLVAMPSolver iteration on the relu net, both message kernels
      against their plain twins at its last iteration's inputs (rtol 1e-4,
      float32), the gated solve converged with v_rel_err_vs_f32 < 1e-3;
   f. the EP golden rows of tests/test_ep_golden.py (copied in
      examples/glm/golden_rows.py): 8 seeds of N = 1000 per row as one
      batched solve, v_EP and the mse within 3.3 sd of the CSV rows and
      v_EP of v_SE;
   g. every other script at its default size, its task-level numbers.

18. (run before the summary) the root entry points,
    tramp_tpu_torch/graft_entry.py (the counterpart of the JAX package's
    __graft_entry__.py), neither of which reaches a kernel: ``entry()`` on
    the card (the flagship at N = 1024, float32), its ``fn`` applied 10
    times against ``iterate(max_iter=10, tol=0)`` of the same student, bit
    for bit, with the kernels and device ms per sweep (loop_window); then
    ``dryrun_multichip(1)`` on one nccl rank, its stage lines in the order
    1, 2, 4, 3 and its seconds.

The messages at a path's final state (11d-f) are held element by element
within rtol (|a| + |a + a_new|) and rtol (|b| + |b + b_new|), the two terms
each subtraction takes; their largest absolute errors go to the kernels
line's ``final_state_max_abs_err`` by path, and ``max_abs_err`` stays phase
3's, at its fixed shapes.

Phase 3 also holds the kernels against their plain versions with 3 lanes
(a precision per lane) at n = 2048 and n = 16384 + 300, checks that lane i of
a batched launch has the bits of the single launch on lane i's data, and
holds them in the same way (plain version, three lanes' bits) and times them
at the batched main path's shape, 2048 lanes of 2048 elements, in float32
and float64.

A kernel's bound is the least time the card could take for the function:
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over the peak rate of their type outside
the tensor cores (67 TFLOP/s in float32, half of that in float64; NVIDIA's
H100 SXM data sheet). Operations are counted from the sources (REGION_OPS
below): every addition, multiplication and division and every call of a
special function counts as one, so the count is a lower bound.

It needs one GPU and imports nothing of JAX.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np

RHO, NOISE = 0.25, 1e-2
RTOL = {"float64": 1e-10, "float32": 1e-4}
V_MSE_BOUND = 5e-2     # bench.py:118-119, relu_net f32 vs f64
FLAGSHIP_BAND = 0.25   # __graft_entry__.py:126
SOLVE = dict(max_iter=500, damping=0.1, tol=1e-6)   # bench.py:1157
SIZES = (2048, 2**20 + 300)
LANES = 2048           # lanes of the batched main paths
LANE_SHAPE = (LANES, 2048)   # the relu net's messages with those lanes
R_TOL = 1e-3           # batched against single, and f64 against the engine
BATCH_TOL = 1e-5       # float32 batched relu net: above the metric's floor
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 33.5e12}
SE_LANE_SHAPE = (1024, 20000)   # 64 x 16 grid points, 2 regions x 100 x 100
CS = dict(prior_type="gauss_bernoulli", output_type="gaussian",
          output_var=1e-11)
# tests/test_golden_csv.py:132-143 (alpha, v, rtol), rho = 0.25, and the
# universality row :261-265
CS_SE_ROWS = [
    (0.02040816326530612, 2.449736425973765e-01, 1e-3),
    (0.40816326530612240, 5.299215508244257e-02, 1e-2),
    (0.81632653061224480, 5.553835940647028e-08, 5e-2),
]
CS_UNIVERSALITY_ROW = (0.02040816326530612, 0.24497364259772186, 1e-3)
# tests/test_golden_csv.py:156-164: rho = linspace(0.05, 0.95, 19)
CS_CRITICAL_REF = [
    0.11866175048828126, 0.20752849365234377, 0.28565310302734376,
    0.3559652514648438, 0.4204180541992188, 0.48096462646484384,
    0.5366284106445314, 0.5893625219726562, 0.6391669604492187,
    0.6860417260742188, 0.7299868188476561, 0.7719787963867187,
    0.8100645434570313, 0.8461971752929689, 0.8803766918945313,
    0.9116265356445312, 0.9389701489257812, 0.9643606469726562,
    0.9858449145507813,
]
ALPHA_TOL = 1e-3
SOURCES = {"pl_posterior": "tramp_tpu_torch/csrc/pl_posterior.cu",
           "pl_forward_message": "tramp_tpu_torch/csrc/pl_message.cu",
           "pl_backward_message": "tramp_tpu_torch/csrc/pl_message.cu"}

# Operations per element, counted from csrc/pl_common.cuh. Per region: the
# tilted Gaussian, mean, variance, log-partition and weight (region_moments
# without the G functions), then G0, G1, G2 by the interval's kind (the
# cheaper branch where the data decides), the x-side moments, the softmax
# weight, and one side's share of the merge.
REGION_OPS = {"moments": 28, "both_inf": 0, "half_inf": 13, "finite": 25,
              "x_side": 3, "softmax": 4, "merge_side": 7}
ELEMENT_OPS = {"softmax": 1, "merge_side": 3, "logZ": 2,
               "mean_and_update": 4}


def check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr)
        sys.exit(1)


def dtype_name(dtype):
    return str(dtype).split(".")[1]


def operations(kernel, specs, n):
    "Operations of one call on n elements (see REGION_OPS)."
    per_element = 0
    for zmin, zmax, _, _ in specs:
        infinite = (zmin == -np.inf) + (zmax == np.inf)
        kind = ("finite", "half_inf", "both_inf")[infinite]
        per_element += (REGION_OPS["moments"] + REGION_OPS[kind]
                        + REGION_OPS["softmax"])
        if kernel == "pl_posterior":
            per_element += REGION_OPS["x_side"] + 2 * REGION_OPS["merge_side"]
        else:
            per_element += REGION_OPS["merge_side"]
            if kernel == "pl_forward_message":
                per_element += REGION_OPS["x_side"]
    per_element += ELEMENT_OPS["softmax"]
    if kernel == "pl_posterior":
        per_element += 2 * ELEMENT_OPS["merge_side"] + ELEMENT_OPS["logZ"]
    else:
        per_element += (ELEMENT_OPS["merge_side"]
                        + ELEMENT_OPS["mean_and_update"])
    return per_element * n


def bound_ms(kernel, specs, n, dtype, lanes=1):
    """(bound in ms, "bytes" or "operations", bytes moved) for ``lanes``
    lanes of n elements with one precision per lane and side: inputs read
    once (bz, bx, az, ax), outputs written once (five streams, or b_new and
    a_new)."""
    itemsize = 4 if dtype_name(dtype) == "float32" else 8
    total = lanes * n
    outputs = 5 * total if kernel == "pl_posterior" else total + lanes
    moved = (2 * total + 2 * lanes + outputs) * itemsize
    by_bytes = moved / HBM_BYTES_PER_S
    by_ops = (operations(kernel, specs, total)
              / PEAK_OPS_PER_S[dtype_name(dtype)])
    which = "bytes" if by_bytes >= by_ops else "operations"
    return 1e3 * max(by_bytes, by_ops), which, moved


def per_call_ms(fn, calls=20, reps=5):
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    calls of ``fn``, per call, in milliseconds: what a caller pays per call,
    host launch overhead included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def host_ms(fn, calls=300):
    """Host time per call in milliseconds: ``calls`` unsynchronised calls on
    the host's clock, the device drained before and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls


def device_events(fn, reps):
    """(device-side events, wall seconds) of ``reps`` warm calls of ``fn``
    under torch.profiler. The profiler now and then hands back a window with
    no device event at all; such a window is taken again, at most twice, and
    the callers fail on a device time of 0."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    return events, wall


def profiled(fn, reps):
    """(kernels launched per call, device ms per call, wall ms per call) of
    ``fn`` from torch.profiler over ``reps`` warm calls. The device time is
    the sum of the device-side events (kernels and copies)."""
    events, wall = device_events(fn, reps)
    kernels = [e for e in events
               if not e.name.lower().startswith(("memcpy", "memset"))]
    device_us = sum(e.time_range.elapsed_us() for e in events)
    return len(kernels) / reps, 1e-3 * device_us / reps, 1e3 * wall / reps


def loop_window(run, iterations=10):
    """What one iteration of a solver's loop costs: ``run(k)`` runs the
    solver for exactly k iterations (with its set-up and its readout), and
    the per-iteration figures are the run of ``iterations`` less the run of
    none, both under torch.profiler. Returns a dict: per iteration
    ``kernels``, ``device_ms``, ``ops`` ({operation: (launches, device
    ms)}) and ``top`` ([(operation, launches, device ms)] for the five
    operations with the most device time); and of the
    whole profiled run of ``iterations`` iterations ``run_device_ms`` and
    ``run_wall_ms``, whose ratio is the busy share under the profiler,
    which slows the host."""
    def reading(k):
        events, wall = device_events(lambda: run(k), 1)
        check(events, "torch.profiler shows no device time")
        by_name = {}
        for e in events:
            count, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, us + e.time_range.elapsed_us())
        return by_name, wall

    full, wall_full = reading(iterations)
    none, _ = reading(0)
    ops = {}
    for name, (count, us) in full.items():
        count0, us0 = none.get(name, (0, 0.0))
        ops[name] = ((count - count0) / iterations,
                     1e-3 * (us - us0) / iterations)
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:5]
    return {
        "iterations": iterations,
        "ops": ops,
        "kernels": sum(c for name, (c, _) in ops.items()
                       if not name.lower().startswith(("memcpy", "memset"))),
        "device_ms": sum(ms for _, ms in ops.values()),
        "top": [(name[:70], c, ms) for name, (c, ms) in top],
        "run_device_ms": 1e-3 * sum(us for _, us in full.values()),
        "run_wall_ms": 1e3 * wall_full}


def print_window(what, window, card):
    device = window["device_ms"]
    print(f"{what}, torch.profiler over {window['iterations']} iterations "
          "less set-up and "
          f"readout: {window['kernels']:.1f} kernels and {device:.4f} ms of "
          "device time per iteration; the profiled run with set-up and "
          f"readout: device {window['run_device_ms']:.4f} ms of "
          f"{window['run_wall_ms']:.4f} ms, busy "
          f"{100 * window['run_device_ms'] / window['run_wall_ms']:.2f}% "
          f"[{card}]")
    for name, count, ms in window["top"]:
        print(f"    {ms:9.4f} ms in {count:5.1f} launches per iteration "
              f"({100 * ms / device:5.1f}% of the device time): {name}")
    return window


def inputs(torch, n, dtype, seed, per_element=False):
    rng = np.random.RandomState(seed)
    bz = torch.as_tensor(2 * rng.randn(n), device="cuda", dtype=dtype)
    bx = torch.as_tensor(2 * rng.randn(n), device="cuda", dtype=dtype)
    if per_element:
        az = torch.as_tensor(1.2 + rng.rand(n), device="cuda", dtype=dtype)
        ax = torch.as_tensor(0.4 + rng.rand(n), device="cuda", dtype=dtype)
    else:
        az = torch.tensor(1.7, device="cuda", dtype=dtype)
        ax = torch.tensor(0.9, device="cuda", dtype=dtype)
    return az, bz, ax, bx


def lane_inputs(torch, lanes, n, dtype, seed):
    "Messages (lanes, n) with a precision per lane and side, (lanes, 1)."
    rng = np.random.RandomState(seed)

    def t(x):
        return torch.as_tensor(x, device="cuda", dtype=dtype)
    bz, bx = t(2 * rng.randn(lanes, n)), t(2 * rng.randn(lanes, n))
    return t(1.2 + rng.rand(lanes, 1)), bz, t(0.4 + rng.rand(lanes, 1)), bx


def hold(torch, what, names, got, want, rtol, floor=0.0, slack=None):
    """Check every stream of ``got`` against ``want``, relative to each
    element with a floor of rtol times the larger of the stream's largest
    magnitude and ``floor``, plus ``slack`` (a tensor per stream, added to
    each element's bound) where given. Returns (worst error over
    tolerance, largest absolute error)."""
    worst, max_err = 0.0, 0.0
    check(len(got) == len(want) == len(names), f"{what}: {len(got)} outputs")
    for k, (name, g, w) in enumerate(zip(names, got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}: {name} is {tuple(g.shape)} {g.dtype}, plain "
              f"{tuple(w.shape)} {w.dtype}")
        check(bool(torch.isfinite(g).all()), f"{what}: {name} not finite")
        err = (g - w).abs()
        bound = rtol * (w.abs() + torch.clamp(w.abs().max(), min=floor))
        if slack is not None:
            bound = bound + slack[k]
        ratio = float((err / bound).max())
        check(ratio <= 1.0, f"{what}: {name} off its plain version by "
                            f"{ratio:.3g} x rtol {rtol:g}")
        worst = max(worst, ratio)
        max_err = max(max_err, float(err.max()))
    return worst, max_err


def compare_posterior(torch, pl, channels):
    """Phase 3, five-output kernel. Returns (max abs error over all cases,
    kernel ms, plain ms at the main path's case: relu, n = 2048, float32)."""
    max_err = 0.0
    main = None
    for dtype in (torch.float64, torch.float32):
        dname = dtype_name(dtype)
        for n in SIZES:
            for channel in channels:
                args = inputs(torch, n, dtype, n + len(channel.name))
                specs = channel.region_specs
                got = pl.pl_posterior(*args, specs)
                want = pl.pl_posterior_plain(*args, specs)
                torch.cuda.synchronize()
                worst, err = hold(
                    torch, f"pl_posterior {channel.name} {dname} n={n}",
                    ("rz", "vz", "rx", "vx", "logZ"), got, want, RTOL[dname])
                max_err = max(max_err, err)
                k_ms = per_call_ms(lambda: pl.pl_posterior(*args, specs))
                p_ms = per_call_ms(lambda: pl.pl_posterior_plain(*args,
                                                                 specs))
                print(f"kernel vs plain: {channel.name:7s} {dname} "
                      f"n={n:8d} err/tol={worst:.2e} (rtol {RTOL[dname]:g}) "
                      f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms")
                if channel.name == "relu" and n == 2048 and \
                        dtype == torch.float32:
                    main = (k_ms, p_ms)
    return max_err, main


def compare_messages(torch, pl, channels):
    """Phase 3, message kernels. Returns {wrapper name: max abs error}."""
    pairs = {"pl_forward_message": (pl.pl_forward_message,
                                    pl.pl_forward_message_plain),
             "pl_backward_message": (pl.pl_backward_message,
                                     pl.pl_backward_message_plain)}
    max_err = dict.fromkeys(pairs, 0.0)
    cases = [(n, False, channels) for n in SIZES]
    # per-element precisions, one element, and an n that is no multiple of 4
    cases += [(2048, True, channels[2:5]), (4099, True, channels[2:5]),
              (1, False, channels[2:5]), (4099, False, channels[2:5]),
              (16384, False, channels[2:5]), (16385, False, channels[2:5])]
    for dtype in (torch.float64, torch.float32):
        dname = dtype_name(dtype)
        for n, per_element, some in cases:
            for channel in some:
                args = inputs(torch, n, dtype, n + len(channel.name),
                              per_element)
                specs = channel.region_specs
                line = (f"message vs plain: {channel.name:7s} {dname} "
                        f"n={n:8d} {'a per element' if per_element else ''}")
                for name, (fused, plain) in pairs.items():
                    got = fused(*args, specs)
                    again = fused(*args, specs)
                    want = plain(*args, specs)
                    torch.cuda.synchronize()
                    what = f"{name} {channel.name} {dname} n={n}"
                    worst, err = hold(torch, what, ("a_new", "b_new"), got,
                                      want, RTOL[dname])
                    check(all(torch.equal(g, a) for g, a in zip(got, again)),
                          f"{what}: two calls differ")
                    max_err[name] = max(max_err[name], err)
                    line += f" {name[3:]} err/tol={worst:.2e}"
                print(line)
    return max_err


def compare_lanes(torch, pl, channels, lanes=3):
    """Phase 3, lanes: all three kernels against their plain versions with a
    precision per lane, and lane i of a batched launch against the single
    launch on lane i's data (the same bits). Returns {wrapper name: max abs
    error}."""
    messages = {"pl_forward_message": (pl.pl_forward_message,
                                       pl.pl_forward_message_plain),
                "pl_backward_message": (pl.pl_backward_message,
                                        pl.pl_backward_message_plain)}
    max_err = dict.fromkeys(["pl_posterior", *messages], 0.0)
    for dtype in (torch.float64, torch.float32):
        dname = dtype_name(dtype)
        for n in (2048, pl.CLUSTER_MAX + 300):
            for channel in channels:
                az, bz, ax, bx = args = lane_inputs(
                    torch, lanes, n, dtype, n + len(channel.name))
                specs = channel.region_specs
                what = f"{channel.name} {dname} {lanes} lanes of n={n}"
                got = pl.pl_posterior(*args, specs)
                want = pl.pl_posterior_plain(*args, specs)
                worst, err = hold(torch, f"pl_posterior {what}",
                                  ("rz", "vz", "rx", "vx", "logZ"), got,
                                  want, RTOL[dname])
                max_err["pl_posterior"] = max(max_err["pl_posterior"], err)
                for i in range(lanes):
                    single = pl.pl_posterior(az[i, 0], bz[i], ax[i, 0],
                                             bx[i], specs)
                    check(all(torch.equal(g[i], s_)
                              for g, s_ in zip(got, single)),
                          f"pl_posterior {what}: lane {i} differs from its "
                          "single launch")
                line = f"lanes vs plain: {what} posterior err/tol={worst:.2e}"
                for name, (fused, plain) in messages.items():
                    before = fused.launches
                    a_new, b_new = fused(*args, specs)
                    check(fused.launches - before
                          == (1 if n <= pl.CLUSTER_MAX else 2),
                          f"{name} {what}: {fused.launches - before} "
                          "launches")
                    want = plain(*args, specs)
                    torch.cuda.synchronize()
                    worst, err = hold(torch, f"{name} {what}",
                                      ("a_new", "b_new"), (a_new, b_new),
                                      want, RTOL[dname])
                    max_err[name] = max(max_err[name], err)
                    for i in range(lanes):
                        a_i, b_i = fused(az[i, 0], bz[i], ax[i, 0], bx[i],
                                         specs)
                        check(torch.equal(a_new[i, 0], a_i)
                              and torch.equal(b_new[i], b_i),
                              f"{name} {what}: lane {i} differs from its "
                              "single launch")
                    line += f" {name[3:]} err/tol={worst:.2e}"
                print(line + "; every lane bit-identical to its single "
                      "launch")
    return max_err


def layout_inputs(torch, lanes, n, dtype, seed, per_element=None):
    """Messages (lanes, n) with a precision per lane, (lanes, 1), or, for
    ``per_element`` "az" or "ax", that side's precision per element."""
    az, bz, ax, bx = lane_inputs(torch, lanes, n, dtype, seed)
    rng = np.random.RandomState(seed + 1)
    if per_element == "az":
        az = az + torch.as_tensor(rng.rand(lanes, n), device="cuda",
                                  dtype=dtype)
    elif per_element == "ax":
        ax = ax + torch.as_tensor(rng.rand(lanes, n), device="cuda",
                                  dtype=dtype)
    return az, bz, ax, bx


ROUNDING_UNITS = 16    # see plain_rounding


def plain_rounding(torch, pl, name, args, specs, want):
    """What rounding alone may move each output ``want`` of the plain
    version by, per element. In float32: twice its distance from the plain
    version in float64 (each version rounds in its own order). In float64,
    which has no wider type on the card: a lane's mean variance v is a
    difference of terms as large as the lane's mean of r^2 + v, so rounding
    moves it by ROUNDING_UNITS epsilons of that (sums of K products r_k^2
    and the moments before them, each off by a few units, in each version),
    and a_new = 1 / v - a and b_new = r (a + a_new) - b follow v's relative
    error."""
    from tramp_tpu_torch.lanes import lane_mean
    plain = getattr(pl, f"{name}_plain")
    if want[0].dtype == torch.float32:
        wide = plain(*(a.double() for a in args), specs)
        return [(2 * (w.double() - x).abs()).float()
                for w, x in zip(want, wide)]
    az, bz, ax, bx = args
    rz, vz, rx, vx, _ = pl.pl_posterior_plain(*args, specs)
    forward = name == "pl_forward_message"
    r, v, a = (rx, vx, ax) if forward else (rz, vz, az)
    cond = lane_mean(r * r + v, az, ax) / lane_mean(v, az, ax)
    rel = ROUNDING_UNITS * torch.finfo(bz.dtype).eps * cond
    inverse = (a + want[0]).abs()
    return rel * inverse, rel * (r * inverse).abs()


#: lanes and n of the message kernels' layouts with lanes (phase 3 and
#: tests/test_torch_pl_message.py): one block per lane up to pl.LANE_MAX
#: elements (several lanes per block up to 1024), one cluster per lane up to
#: pl.CLUSTER_MAX, and the two launches above it
LAYOUT_LANES = (2, 3, 257)
LAYOUT_SIZES = (1, 31, 511, 512, 513, 2048, 2049, 4096, 4097)


def stairs():
    """A channel of four regions, more than any of the repo's: its kernels
    are built with other launch bounds (kLaneMinBlocks in
    csrc/pl_message.cu)."""
    from tramp_tpu_torch.channels import PiecewiseLinearChannel
    inf = math.inf
    return PiecewiseLinearChannel("stairs", [
        dict(zmin=1.0, zmax=inf, slope=0.0, x0=1.0),
        dict(zmin=0.0, zmax=1.0, slope=1.0, x0=0.0),
        dict(zmin=-1.0, zmax=0.0, slope=0.5, x0=0.0),
        dict(zmin=-inf, zmax=-1.0, slope=0.0, x0=-0.5)])


def compare_lane_layouts(torch, pl, channels, dtypes=None,
                         per_elements=(None, "az", "ax")):
    """Phase 3, the message kernels' layouts with lanes: LAYOUT_LANES lanes
    of every n of LAYOUT_SIZES and pl.LANE_MAX (+ 1), a precision per lane
    or per element of either side (``per_elements``): each against its
    plain version, and every lane against the single launch on its data
    (the same bits). An element may also differ by what rounding alone
    moves it by (``plain_rounding``): with one element a lane the hard
    tanh's x-side variance is a difference of nearly equal terms (r^2 / v
    up to 1.3e7), where float32 rounding alone moves a_new by up to 60% and
    float64 rounding by more than 1e-10."""
    messages = {"pl_forward_message": (pl.pl_forward_message,
                                       pl.pl_forward_message_plain),
                "pl_backward_message": (pl.pl_backward_message,
                                        pl.pl_backward_message_plain)}
    sizes = tuple(sorted(set(LAYOUT_SIZES)
                         | {pl.LANE_MAX, pl.LANE_MAX + 1}))
    for dtype in dtypes or (torch.float64, torch.float32):
        dname = dtype_name(dtype)
        worst, largest = (dict.fromkeys(messages, 0.0) for _ in range(2))
        for lanes in LAYOUT_LANES:
            for n in sizes:
                for channel in channels:
                    for per_element in per_elements:
                        args = layout_inputs(torch, lanes, n, dtype,
                                             n + lanes, per_element)
                        specs = channel.region_specs
                        what = (f"{channel.name} {dname} {lanes} lanes of "
                                f"n={n}, {per_element or 'a'} per "
                                f"{'element' if per_element else 'lane'}")
                        for name, (fused, plain) in messages.items():
                            before = fused.launches
                            got = fused(*args, specs)
                            check(fused.launches - before == (
                                      1 if n <= pl.CLUSTER_MAX else 2),
                                  f"{name} {what}: "
                                  f"{fused.launches - before} launches")
                            want = plain(*args, specs)
                            slack = plain_rounding(torch, pl, name, args,
                                                   specs, want)
                            torch.cuda.synchronize()
                            ratio, err = hold(torch, f"{name} {what}",
                                              ("a_new", "b_new"), got, want,
                                              RTOL[dname], slack=slack)
                            worst[name] = max(worst[name], ratio)
                            largest[name] = max(largest[name], err)
                            for i in range(lanes):
                                single = fused(*(
                                    a[i] if a.shape[1] == n else a[i, 0]
                                    for a in args), specs)
                                check(torch.equal(
                                    got[0][i].reshape(single[0].shape),
                                    single[0])
                                    and torch.equal(got[1][i], single[1]),
                                    f"{name} {what}: lane {i} differs from "
                                    "its single launch")
        print(f"lane layouts vs plain: {dname}, "
              f"{', '.join(c.name for c in channels)}, "
              f"{', '.join(map(str, LAYOUT_LANES))} lanes of n in {sizes}, "
              f"a per lane or per element of either side: "
              + ", ".join(f"{k[3:]} worst err/tol={v:.2e}"
                          for k, v in worst.items())
              + ", largest abs err " + ", ".join(
                  f"{k[3:]} {v:.3g}" for k, v in largest.items())
              + f" (rtol {RTOL[dname]:g}); every lane bit-identical to its "
              "single launch")


def hold_main_shape(torch, pl, channel):
    """Phase 3, the batched main path's shape (LANES lanes of 2048 elements,
    a precision per lane), float32 and float64: all three kernels against
    their plain versions on the same inputs, and three lanes against their
    single launches (the same bits). Returns ({wrapper name: max abs error},
    {wrapper name: the plain version's ms per call in float32})."""
    cases = {
        "pl_posterior": (pl.pl_posterior, pl.pl_posterior_plain,
                         ("rz", "vz", "rx", "vx", "logZ")),
        "pl_forward_message": (pl.pl_forward_message,
                               pl.pl_forward_message_plain,
                               ("a_new", "b_new")),
        "pl_backward_message": (pl.pl_backward_message,
                                pl.pl_backward_message_plain,
                                ("a_new", "b_new"))}
    specs = channel.region_specs
    lanes, n = LANE_SHAPE
    max_err, plain_ms = dict.fromkeys(cases, 0.0), {}
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        az, bz, ax, bx = args = lane_inputs(torch, lanes, n, dtype, 3)
        line = (f"lanes vs plain: {channel.name} {dname} {lanes} lanes of "
                f"n={n}")
        for name, (fused, plain, streams) in cases.items():
            what = f"{name} {channel.name} {dname} {lanes} lanes of n={n}"
            got = fused(*args, specs)
            want = plain(*args, specs)
            torch.cuda.synchronize()
            worst, err = hold(torch, what, streams, got, want, RTOL[dname])
            max_err[name] = max(max_err[name], err)
            for i in (0, lanes // 2, lanes - 1):
                single = fused(az[i, 0], bz[i], ax[i, 0], bx[i], specs)
                check(all(torch.equal(g[i].reshape(s_.shape), s_)
                          for g, s_ in zip(got, single)),
                      f"{what}: lane {i} differs from its single launch")
            line += f" {name[3:]} err/tol={worst:.2e}"
            del got, want
            if dtype == torch.float32:
                plain_ms[name] = per_call_ms(
                    lambda: plain(*args, specs), calls=3, reps=3)
        print(line + f" (rtol {RTOL[dname]:g}); lanes 0, {lanes // 2} and "
              f"{lanes - 1} bit-identical to their single launches")
    return max_err, plain_ms


def time_fusion(torch, pl, base, specs):
    """Phase 3: the composition the sweep ran before the fusion against the
    fused forward message at the main path's case (relu, n = 2048, float32),
    in turns old, new, new, old."""
    az, bz, ax, bx = inputs(torch, 2048, torch.float32, 7)

    def old():
        _, _, rx, vx, _ = pl.pl_posterior(az, bz, ax, bx, specs)
        return base.compute_ab_new(rx, torch.mean(vx), ax, bx)

    def new():
        return pl.pl_forward_message(az, bz, ax, bx, specs)

    got, want = new(), old()
    torch.cuda.synchronize()
    hold(torch, "fused forward message vs composition", ("a_new", "b_new"),
         got, want, RTOL["float32"])
    out = {"old": [], "new": []}
    for name, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        kernels, device, _ = profiled(fn, 50)
        out[name].append((per_call_ms(fn, calls=100), host_ms(fn), kernels,
                          device))
    floor = (per_call_ms(pl.launch_floor, calls=100),
             host_ms(pl.launch_floor), profiled(pl.launch_floor, 50)[1])
    for name, label in (("old", "posterior kernel + mean + compute_ab_new"),
                        ("new", "fused forward message")):
        for call_ms, h_ms, kernels, device in out[name]:
            print(f"message at relu n=2048 float32, {label}: "
                  f"{1e3 * call_ms:.2f} us per call, {1e3 * h_ms:.2f} us "
                  f"host per call, {kernels:.1f} kernels, "
                  f"{1e3 * device:.2f} us device")
    print(f"empty kernel: {1e3 * floor[0]:.2f} us per call, "
          f"{1e3 * floor[1]:.2f} us host per call, {1e3 * floor[2]:.2f} us "
          "device")
    # exactly one launch per call, by the wrapper's own count (the
    # profiler's count above is printed only: it may drop an event)
    before = pl.pl_forward_message.launches
    for _ in range(50):
        new()
    torch.cuda.synchronize()
    launched = pl.pl_forward_message.launches - before
    check(launched == 50, "the fused message at n = 2048 launched "
          f"{launched} kernels in 50 calls, want 50")


def kernel_table(torch, pl, channels, card):
    """Phase 3: device time (torch.profiler), time per call (CUDA events) and
    host time per call of every kernel beside its bound, for relu and one
    three-region channel."""
    rows = {}
    wrappers = {"pl_posterior": pl.pl_posterior,
                "pl_forward_message": pl.pl_forward_message,
                "pl_backward_message": pl.pl_backward_message}
    for channel in channels:
        specs = channel.region_specs
        for dtype in (torch.float32, torch.float64):
            for n in SIZES:
                args = inputs(torch, n, dtype, 3)
                for name, fn in wrappers.items():
                    def call():
                        return fn(*args, specs)
                    kernels, device, _ = profiled(call, 20)
                    check(device > 0, "torch.profiler shows no device time")
                    b_ms, by, moved = bound_ms(name, specs, n, dtype)
                    c_ms, h_ms = per_call_ms(call), host_ms(call, calls=100)
                    rows[name, channel.name, dtype_name(dtype), n] = dict(
                        device_ms=device, per_call_ms=c_ms, host_ms=h_ms,
                        bound_ms=b_ms, bound_by=by)
                    print(f"kernel time: {name:20s} {channel.name:7s} "
                          f"{dtype_name(dtype)} n={n:8d} device "
                          f"{1e3 * device:.2f} us ({kernels:.0f} "
                          f"launches), per call {1e3 * c_ms:.2f} us, host "
                          f"{1e3 * h_ms:.2f} us, bound {1e3 * b_ms:.4f} us "
                          f"by {by} ({moved} B), share "
                          f"{100 * b_ms / device:.2f}% [{card}]")
    # the batched main path's shape: LANES lanes of 2048 elements
    lanes, n = LANE_SHAPE
    for channel in channels:
        specs = channel.region_specs
        for dtype in (torch.float32, torch.float64):
            args = lane_inputs(torch, lanes, n, dtype, 3)
            for name, fn in wrappers.items():
                def call():
                    return fn(*args, specs)
                kernels, device, _ = profiled(call, 10)
                check(device > 0, "torch.profiler shows no device time")
                b_ms, by, moved = bound_ms(name, specs, n, dtype, lanes)
                c_ms, h_ms = per_call_ms(call), host_ms(call, calls=100)
                rows[name, channel.name, dtype_name(dtype), LANE_SHAPE] = \
                    dict(device_ms=device, per_call_ms=c_ms, host_ms=h_ms,
                         bound_ms=b_ms, bound_by=by)
                print(f"kernel time: {name:20s} {channel.name:7s} "
                      f"{dtype_name(dtype)} {lanes} lanes of n={n} device "
                      f"{1e3 * device:.2f} us ({kernels:.0f} launches), "
                      f"per call {1e3 * c_ms:.2f} us, host "
                      f"{1e3 * h_ms:.2f} us, bound {1e3 * b_ms:.4f} us by "
                      f"{by} ({moved} B), share "
                      f"{100 * b_ms / device:.2f}% [{card}]")
    return rows


def relu_net(torch, tt, dtype, N=4096, alpha=0.5, device="cuda", svd=None,
             ReluChannel=None):
    """The relu-net student, data from np.random.RandomState(11).
    ``ReluChannel``: another class for the relu factor than the port's."""
    from tramp_tpu_torch import channels
    from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    ReluChannel = ReluChannel or channels.ReluChannel
    M = int(alpha * N)
    rng = np.random.RandomState(11)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = (rng.rand(N) < RHO) * rng.randn(N)
    y = np.maximum(W @ x0, 0.0) + np.sqrt(NOISE) * rng.randn(M)
    linear = LinearChannel(W, name="W", svd=svd, device=device, dtype=dtype)
    teacher = (
        GaussBernoulliPrior(size=N, rho=RHO, device=device, dtype=dtype)
        @ tt.V(id="x") @ linear @ tt.V(id="z") @ ReluChannel()
        @ tt.V(id="a") @ GaussianChannel(var=NOISE) @ tt.O(id="y")
    ).to_model()
    y = torch.as_tensor(y, device=device, dtype=dtype)
    return teacher.to_observed({"y": y}), x0, linear


#: (lanes, n) at which the Gauss-Bernoulli prior's kernel is held and timed:
#: the relu batch, the GLM batch, one relu instance (None: no lane axis)
GB_SHAPES = ((LANES, 4096), (LANES, 10_000), (None, 4096))
#: the cell's shape of each wrapper's kernels-line row, in float64
GB_MAIN = {"gb_posterior": (LANES, 10_000), "gb_message": (LANES, 4096)}
#: (the full-width output, the per-lane one) as tests/test_torch_gb_prior_
#: kernel.py holds them: against the lane's largest magnitude, relative
GB_RTOL = {"float64": (1e-13, 1e-14), "float32": (1e-5, 1e-5)}


def gb_inputs(torch, lanes, n, dtype, seed):
    """(ax, bx) of the prior's kernel on the card: bx the cavity of a sparse
    signal, ax 0-d or one value per lane in [1, 2)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=dtype, device="cuda")
    rows = lanes or 1
    x = ((torch.rand(rows, n, generator=g, **kw) < RHO)
         * torch.randn(rows, n, generator=g, **kw))
    ax = 1.0 + torch.rand(rows, 1, generator=g, **kw)
    bx = ax * x + ax.sqrt() * torch.randn(rows, n, generator=g, **kw)
    if lanes is None:
        return ax.reshape(()), bx.reshape(n)
    return ax, bx


def hold_gb_prior(torch, card):
    """Phase 3, the Gauss-Bernoulli prior's kernel (ops/gb_prior.py): its
    build and ptxas report, then both wrappers against their plain versions
    at GB_SHAPES in float32 and float64 (GB_RTOL), one launch a call, with
    the device time per call (torch.profiler over 20 calls), the time per
    call (CUDA events), the host time, the byte bound and the plain
    version's device time and kernels. Returns {wrapper: {(lanes, n,
    dtype name): reading}}."""
    from portbench.metrics.gb_prior_roofline import bound_s
    from tramp_tpu_torch.ops import _build, gb_prior
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    t0 = time.perf_counter()
    lib, log = gb_prior.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    rows = [row for row in _build.ptxas_report(log)
            if row["kernel"].startswith("gb_prior")]
    for row in rows:
        print(f"ptxas: {row['kernel']}<{row['dtype']}, "
              f"{', '.join(map(str, row['params']))}> {row['registers']} "
              f"registers, {row['spill_bytes']} bytes of spill stores")
    # posterior and message, 16-byte and single-element loads, two types
    check(len(rows) == 8 and not any(row["spill_bytes"] for row in rows),
          f"gb_prior: ptxas reported {rows}")
    prior = GaussBernoulliPrior(size=1, rho=RHO)
    hyper = (prior.a, prior.b, prior.eta)
    out = {"gb_posterior": {}, "gb_message": {}}
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        rtol_full, rtol_lane = GB_RTOL[dname]
        for lanes, n in GB_SHAPES:
            ax, bx = gb_inputs(torch, lanes, n, dtype, seed=n)
            rows_ = lanes or 1
            bound_ms = 1e3 * bound_s(rows_, n, bx.element_size())
            for name, order in (("gb_posterior", 1), ("gb_message", -1)):
                fn = getattr(gb_prior, name)
                plain = getattr(gb_prior, f"{name}_plain")
                what = f"{name} {dname} lanes={lanes} n={n}"
                before = fn.launches
                full, per_lane = fn(ax, bx, *hyper)[::order]
                check(fn.launches == before + 1,
                      f"{what}: {fn.launches - before} launches, want 1")
                want_full, want_lane = plain(ax, bx, *hyper)[::order]
                torch.cuda.synchronize()
                check(full.shape == want_full.shape
                      and per_lane.shape == want_lane.shape
                      and bool(torch.isfinite(full).all())
                      and bool(torch.isfinite(per_lane).all()),
                      f"{what}: shapes {tuple(full.shape)}, "
                      f"{tuple(per_lane.shape)} or not finite")
                err = (full - want_full).abs().reshape(rows_, -1)
                scale = want_full.abs().reshape(rows_, -1).amax(
                    -1, keepdim=True)
                full_ratio = float((err / (rtol_full * scale)).max())
                lane_ratio = float(((per_lane - want_lane).abs()
                                    / (rtol_lane * want_lane.abs())).max())
                check(full_ratio <= 1.0 and lane_ratio <= 1.0,
                      f"{what}: {full_ratio:.3g} and {lane_ratio:.3g} of "
                      "the tolerances (full width, per lane)")
                kernels, device_ms, _ = profiled(
                    lambda: fn(ax, bx, *hyper), 20)
                plain_kernels, plain_ms, _ = profiled(
                    lambda: plain(ax, bx, *hyper), 5)
                check(device_ms > 0 and plain_ms > 0,
                      f"{what}: torch.profiler shows no device time")
                reading = out[name][lanes, n, dname] = {
                    "shape": [lanes, n], "dtype": dname,
                    "max_abs_err": float(err.max()),
                    "of_rtol": max(full_ratio, lane_ratio),
                    "kernels": kernels, "device_ms": device_ms,
                    "ms": per_call_ms(lambda: fn(ax, bx, *hyper)),
                    "host_ms": host_ms(lambda: fn(ax, bx, *hyper)),
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "share": bound_ms / device_ms,
                    "plain_ms": plain_ms, "plain_kernels": plain_kernels}
                print(f"{what}: {reading['of_rtol']:.3g} of the tolerance; "
                      f"device {1e3 * device_ms:.2f} us ({kernels:.0f} "
                      f"launches), per call {1e3 * reading['ms']:.2f} us, "
                      f"host {1e3 * reading['host_ms']:.2f} us, bound "
                      f"{1e3 * bound_ms:.2f} us "
                      f"({100 * reading['share']:.1f}%); plain "
                      f"{1e3 * plain_ms:.2f} us ({plain_kernels:.0f} "
                      f"kernels) [{card}]")
    return out


def read_gb_launches():
    "The Gauss-Bernoulli prior kernel's launches since ``reset_launches``."
    from tramp_tpu_torch.ops import gb_prior
    return {"gb_posterior": gb_prior.gb_posterior.launches,
            "gb_message": gb_prior.gb_message.launches}


#: (dtype name, lanes) at which ML-VAMP's loop finish is held and timed on
#: the relu net: the batch in both types, one instance (None: no lane axis)
FINISH_SHAPES = (("float64", LANES), ("float32", LANES), ("float64", None))
#: delta's sums are taken in another order than torch.mean's: its ulps
FINISH_ULPS = 4


def finish_state(torch, student, lanes, seed=0):
    """ML-VAMP's loop on ``student`` (a relu net of ``relu_net``) three
    iterations in, with ``lanes`` observations about its own (None: one
    instance): (solver, the loop state, the step's output from it, the
    invariants, B)."""
    from tramp_tpu_torch.parallel import MLVAMPSolver, with_buffers
    model = student
    if lanes is not None:
        y = student.factors[-1].y
        g = torch.Generator(device=y.device).manual_seed(seed)
        ys = y + 0.01 * torch.randn((lanes,) + y.shape, generator=g,
                                    dtype=y.dtype, device=y.device)
        model = with_buffers(student, {(len(student.factors) - 1, "y"): ys})
    solver = MLVAMPSolver(student, **SOLVE)
    B, _, inv, _ = solver._prepare(model, None)
    state = solver._start(model, inv, B, None)
    for _ in range(3):
        solver._iterate(model, inv, B, state, solver.tol)
    return solver, state, solver._step(model, state["carry"], inv), inv, B


def finish_args(torch, solver, state, new, inv, B):
    """The finish's arguments (without tol) on copies of the loop state's
    carry, metric and flags, and its byte bound: each leaf of the step's
    output, the pinned message and the old metric read once, each carry
    leaf and the metric written once."""
    from tramp_tpu_torch.ops import ml_vamp_finish as mvf
    from tramp_tpu_torch.parallel.mesh import map_tree
    old = state["carry"]
    carry, metric, flags = map_tree(
        torch.clone, (old, state["metric"], state["flags"]))
    pairs = [(c if n is o else n, c) for (n, o), (c, _) in zip(
        solver._pairs(new, old), solver._pairs(carry, old))]
    args = (pairs, solver._sides(carry, inv), metric, flags, B)
    leaves, _ = mvf._table(*args)
    elements = (sum(n.numel() + (0 if c is None else c.numel())
                    for n, c, _, _ in leaves)
                + 2 * sum(r.numel() for r in metric))
    return args, elements * metric[0].element_size()


def time_finish(torch, fn, args, nbytes, reps=20):
    """``fn``'s device time per call (torch.profiler over ``reps`` calls),
    its kernels, time per call (CUDA events), host time, and the byte
    bound, at a tol no lane meets: no call freezes a lane, so every call
    copies every lane's carry, as an iteration of a solve does."""
    def call():
        return fn(*args, -1.0)
    kernels, device_ms, _ = profiled(call, reps)
    check(device_ms > 0, f"{fn.__name__}: torch.profiler shows no device "
                         "time")
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"kernels": kernels, "device_ms": device_ms,
            "ms": per_call_ms(call), "host_ms": host_ms(call),
            "bound_ms": bound, "bound_by": "bytes",
            "share": bound / device_ms}


def hold_ml_vamp_finish(torch, students, card):
    """Phase 3, ML-VAMP's loop finish (ops/ml_vamp_finish.py): its build
    and ptxas report, then the kernel against its plain version on the
    relu net's loop state at FINISH_SHAPES (``students``: {dtype name:
    (student, x0, linear)}): the carry, the metric, the flags, ok and
    converged bit for bit, delta within FINISH_ULPS, one launch a call;
    each case timed (``time_finish``) beside the plain version's device
    time. Returns {(dtype name, lanes): reading}."""
    from tramp_tpu_torch.ops import _build
    from tramp_tpu_torch.ops import ml_vamp_finish as mvf
    from tramp_tpu_torch.parallel import loop
    t0 = time.perf_counter()
    lib, log = mvf.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    rows = [row for row in _build.ptxas_report(log)
            if row["kernel"] == "ml_vamp_finish_kernel"]
    for row in rows:
        print(f"ptxas: {row['kernel']}<{row['dtype']}, "
              f"{', '.join(map(str, row['params']))}> {row['registers']} "
              f"registers, {row['spill_bytes']} bytes of spill stores")
    # float32 and float64
    check(len(rows) == 2 and not any(row["spill_bytes"] for row in rows),
          f"ml_vamp_finish: ptxas reported {rows}")

    def bits(t):
        return t.view({torch.float64: torch.int64,
                       torch.float32: torch.int32}.get(t.dtype, t.dtype))

    out = {}
    for dname, lanes in FINISH_SHAPES:
        student = students[dname][0]
        what = f"ml_vamp_finish {dname} lanes={lanes} (relu net)"
        solver, state, new, inv, B = finish_state(torch, student, lanes)
        got = []
        for fn in (mvf.ml_vamp_finish, mvf.ml_vamp_finish_plain):
            args, nbytes = finish_args(torch, solver, state, new, inv, B)
            if B is not None:
                args[3]["done"][::3] = True       # frozen lanes
            check(mvf.takes(*args), f"{what}: the kernel does not take it")
            before = mvf.ml_vamp_finish.launches
            result = fn(*args, solver.tol)
            torch.cuda.synchronize()
            check(mvf.ml_vamp_finish.launches - before
                  == (fn is mvf.ml_vamp_finish),
                  f"{what}: {mvf.ml_vamp_finish.launches - before} launches "
                  f"of the kernel by {fn.__name__}")
            got.append((loop.leaves(args[0]) + list(args[2])
                        + loop.leaves(args[3]) + list(result[:2]),
                        result[2]))
        (state_k, delta), (state_w, delta_w) = got
        check(all(g.shape == w.shape and torch.equal(bits(g), bits(w))
                  for g, w in zip(state_k, state_w)),
              f"{what}: carry, metric, flags, ok or converged differ from "
              "the plain version's bits")
        finite = ~delta_w.isnan()
        err = (delta - delta_w).abs()[finite]
        info = torch.finfo(delta.dtype)
        # a frozen lane's delta is 0 in both
        ulps = float((err / (info.eps * delta_w.abs()[finite]).clamp(
            min=info.tiny)).max())
        check(torch.equal(delta.isnan(), delta_w.isnan())
              and ulps <= FINISH_ULPS,
              f"{what}: delta {ulps:.3g} ulps from the plain version's")
        # no lane frozen: every call copies every lane's carry
        args, nbytes = finish_args(torch, solver, state, new, inv, B)
        carried = sum(c.numel() for _, c in args[0]) // (lanes or 1)
        reading = out[dname, lanes] = dict(
            time_finish(torch, mvf.ml_vamp_finish, args, nbytes),
            shape=[lanes, carried], dtype=dname, max_abs_err=float(err.max()), delta_ulps=ulps,
            bytes=nbytes)
        plain = time_finish(torch, mvf.ml_vamp_finish_plain, args, nbytes,
                            reps=5)
        reading.update(plain_ms=plain["device_ms"],
                       plain_kernels=plain["kernels"])
        print(f"{what}: bit for bit, delta within {ulps:.3g} ulps; device "
              f"{1e3 * reading['device_ms']:.2f} us "
              f"({reading['kernels']:.0f} launches), per call "
              f"{1e3 * reading['ms']:.2f} us, host "
              f"{1e3 * reading['host_ms']:.2f} us, bound "
              f"{1e3 * reading['bound_ms']:.2f} us ({nbytes} B, "
              f"{100 * reading['share']:.1f}%); plain "
              f"{1e3 * reading['plain_ms']:.2f} us "
              f"({reading['plain_kernels']:.0f} kernels) [{card}]")
    return out


def read_finish_launches():
    "ML-VAMP's loop finish kernel's launches since ``reset_launches``."
    from tramp_tpu_torch.ops import ml_vamp_finish as mvf
    return mvf.ml_vamp_finish.launches


def reset_launches(pl):
    """Sets every kernel's launch count to 0 (the prior's kernel's and the
    loop finish's too)."""
    from tramp_tpu_torch.ops import gb_prior, ml_vamp_finish
    for fn in (pl.pl_posterior, pl.pl_forward_message,
               pl.pl_backward_message, gb_prior.gb_posterior,
               gb_prior.gb_message, ml_vamp_finish.ml_vamp_finish):
        fn.launches = 0


def read_launches(pl):
    return {"pl_posterior": pl.pl_posterior.launches,
            "pl_forward_message": pl.pl_forward_message.launches,
            "pl_backward_message": pl.pl_backward_message.launches}


def solve(torch, tt, pl, student, x0, gb=None):
    """Solve twice: once to warm up (library handles, lazily loaded
    kernels), then timed, with the kernels' launch counts set to 0 just
    before and read just after. Returns (engine, mse, v, wall seconds,
    launches by kernel); the prior kernel's launches go into the dict
    ``gb`` where one is given."""
    ep = tt.ExpectationPropagation(student)
    ep.iterate(**SOLVE)
    torch.cuda.synchronize()
    reset_launches(pl)
    t0 = time.perf_counter()
    ep.iterate(**SOLVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    if gb is not None:
        gb.update(read_gb_launches())
    x = ep.get_variable_data("x")
    r = x["r"].double().cpu().numpy()
    check(np.isfinite(r).all() and bool(torch.isfinite(x["v"]).all()),
          "non-finite x posterior")
    check(r.shape == x0.shape, f"x posterior shape {r.shape}")
    mse = float(np.mean((r - x0) ** 2))
    return ep, mse, float(x["v"].double().mean()), wall, launches


def read_relu_posteriors(torch, pl, ep):
    """The relu factor's forward and backward posteriors at the engine's
    fixed point, through the channel's own methods: the five-output
    kernel's path. Returns its launches."""
    from tramp_tpu_torch.algos.message_passing import slot, FWD, BWD
    from tramp_tpu_torch.channels import ReluChannel
    i = next(i for i, n in enumerate(ep.nodes) if isinstance(n, ReluChannel))
    fwd = ep.state[slot(ep.model.in_edges[i][0], FWD)]
    bwd = ep.state[slot(ep.model.out_edges[i][0], BWD)]
    args = (fwd["a"], fwd["b"], bwd["a"], bwd["b"])
    reset_launches(pl)
    rx, vx = ep.nodes[i].compute_forward_posterior(*args)
    rz, vz = ep.nodes[i].compute_backward_posterior(*args)
    torch.cuda.synchronize()
    launches = read_launches(pl)["pl_posterior"]
    want = pl.pl_posterior_plain(*args, ep.nodes[i].region_specs)
    rtol = RTOL[dtype_name(rx.dtype)]
    hold(torch, "relu posteriors at the fixed point",
         ("rz", "vz", "rx", "vx"),
         (rz, vz, rx, vx), (want[0], want[1].mean(), want[2], want[3].mean()),
         rtol)
    check(rx.shape == rz.shape == fwd["b"].shape and vx.ndim == vz.ndim == 0,
          "relu posteriors: shapes")
    return launches


def sweep_window(ep, sweeps=10):
    """torch.profiler over ``sweeps`` warm sweeps from the engine's fixed
    point (tol=0: the stop rule never fires; one iterate call of as many
    sweeps warms up first). Returns (kernels, device ms, wall ms), each per
    sweep."""
    before = ep.n_iter
    kernels, device, wall_ms = profiled(
        lambda: ep.iterate(max_iter=sweeps, warm_start=True, tol=0.0), 1)
    check(ep.n_iter - before == 2 * sweeps,
          f"the profiled window ran {ep.n_iter - before} sweeps")
    check(device > 0, "torch.profiler shows no device time")
    return kernels / sweeps, device / sweeps, wall_ms / sweeps


def worst_of(values):
    "The largest of ``values``, NaN if one is NaN (Python's max drops it)."
    return float(np.max(np.asarray(list(values), dtype=np.float64)))


def rel_to_largest(torch, got, want):
    "max |got - want| over the largest |want|."
    return float((got - want).abs().max() / want.abs().max())


def batch_of_observations(torch, W, lanes, relu, seed):
    """One observation per lane, drawn on the card from the teacher
    x ~ Gauss-Bernoulli(RHO), y = [relu](W x) + noise, with an explicit
    generator: (x of shape (lanes, N), y of shape (lanes, M))."""
    g = torch.Generator(device=W.device).manual_seed(seed)
    kw = dict(generator=g, device=W.device, dtype=W.dtype)
    M, N = W.shape
    x = torch.randn((lanes, N), **kw) * (torch.rand((lanes, N), **kw) < RHO)
    z = x @ W.T
    if relu:
        z = torch.relu(z)
    return x, z + np.sqrt(NOISE) * torch.randn((lanes, M), **kw)


def batched_solve(torch, pl, what, run, lanes, card, window, warm_up=True,
                  gb=None):
    """Run a batched solve (after a warm-up run of the same, if asked),
    timed, with the kernels' launch counts set to 0 just before and read
    just after; ``run()`` returns (post, n_iter, conv). Prints the
    readings, with the busy share of this unprofiled run: the device time
    per iteration of ``window`` (loop_window) over the wall time per
    iteration here. Returns (post, n_iter, conv, launches); the prior
    kernel's launches go into the dict ``gb`` where one is given."""
    if warm_up:
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(pl)
    t0 = time.perf_counter()
    post, n_iter, conv = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    if gb is not None:
        gb.update(read_gb_launches())
    peak = torch.cuda.max_memory_allocated()
    check(n_iter.shape == (lanes,) and conv.shape == (lanes,),
          f"{what}: n_iter {tuple(n_iter.shape)}, conv {tuple(conv.shape)}")
    for vid, data in post.items():
        check(data["r"].shape[0] == lanes and data["v"].shape == (lanes,)
              and bool(torch.isfinite(data["r"]).all())
              and bool(torch.isfinite(data["v"]).all()),
              f"{what}: posterior of {vid} has shapes "
              f"{tuple(data['r'].shape)}, {tuple(data['v'].shape)} or is "
              "not finite")
    iterations = int(n_iter.max())
    lane_iterations = int(n_iter.sum())
    print(f"{what}: {lanes} lanes, {int(conv.sum())} converged, "
          f"{iterations} iterations of the loop (per lane "
          f"{int(n_iter.min())} to {iterations}, mean "
          f"{lane_iterations / lanes:.2f}), {wall:.4f} s, "
          f"{lane_iterations / wall:.1f} lane-iterations/s, "
          f"{1e3 * wall / iterations:.4f} ms per iteration, of which "
          f"{window['device_ms']:.4f} ms on the device (busy "
          f"{100 * window['device_ms'] * iterations / (1e3 * wall):.2f}%), "
          f"peak memory {peak} B ({peak / 2**30:.3f} GiB), launches "
          f"{launches} [{card}]")
    return post, n_iter, conv, launches


def stop_metric_floor(torch, solver, model, lanes, sweeps=60):
    """An MLVAMPSolver's stop metric, the largest relative change of a
    posterior mean, at each of ``sweeps`` sweeps from the initial state, as
    a tensor (sweeps, lanes) ((sweeps, 1) without lanes): well past the 26
    sweeps a solve takes, what is left at the end is rounding."""
    from tramp_tpu_torch.lanes import per_lane
    inv = solver._invariants(model, lanes)
    carry = solver._init(model, lanes)
    old = solver._metric(carry, inv)

    def norm(x):
        return torch.sqrt(per_lane(x**2, lanes).mean(-1))

    history = []
    for _ in range(sweeps):
        carry = solver._step(model, carry, inv)
        new = solver._metric(carry, inv)
        history.append(torch.stack(
            [norm(n - o) / norm(n)
             for n, o in zip(new, old)]).amax(0).reshape(-1))
        old = new
    return torch.stack(history)


def lanes_against_singles(torch, what, solver, student, likelihood, ys,
                          post, n_iter, ids=("x",)):
    """Three lanes of a batched solve against their single solves: r of
    every id within R_TOL of its largest |r|, n_iter within 2 (a GEMM and a
    GEMV sum in different orders in float32)."""
    from tramp_tpu_torch.parallel import with_buffers
    for lane in (0, len(ys) // 2, len(ys) - 1):
        single = with_buffers(student, {(likelihood, "y"): ys[lane]})
        post_1, n_1 = solver.solve(single)
        err = worst_of(rel_to_largest(torch, post[id]["r"][lane],
                                      post_1[id]["r"]) for id in ids)
        check(err < R_TOL and abs(int(n_iter[lane]) - int(n_1)) <= 2,
              f"{what}: lane {lane} is {err:.3g} of the largest |r| off its "
              f"single solve (bound {R_TOL}), n_iter {int(n_iter[lane])} vs "
              f"{int(n_1)}")
        print(f"{what}: lane {lane} vs its single solve: r within "
              f"{err:.3e} of the largest |r| (bound {R_TOL}), n_iter "
              f"{int(n_iter[lane])} vs {int(n_1)}")


def front_door_flagship(torch, tt, pl, student, teacher_x, linear, engine_v,
                        card):
    """Phase 6: the flagship through dispatch_solver, one solve and LANES
    lanes. Returns the launches of the path by kernel: none of pl_fused's,
    and one of the prior's posterior per iteration and readout (checked),
    as a second dict."""
    from tramp_tpu_torch.parallel import (
        SpectralVAMPSolver, dispatch_solver, with_buffers)
    solver = dispatch_solver(student)
    check(type(solver) is SpectralVAMPSolver,
          f"flagship: dispatch_solver gave {type(solver).__name__}")
    solver.solve(student)
    torch.cuda.synchronize()
    reset_launches(pl)
    t0 = time.perf_counter()
    post, n_iter, conv = solver.solve_info(student)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    gb = read_gb_launches()
    r, v = post["x"]["r"], float(post["x"]["v"])
    check(bool(conv) and bool(torch.isfinite(r).all()),
          f"flagship through the front door: conv={bool(conv)}")
    mse = float(((r - teacher_x) ** 2).mean())
    band, v_rel = abs(mse - v) / v, abs(v - engine_v) / engine_v
    check(band < FLAGSHIP_BAND and v_rel < 1e-2,
          f"flagship through the front door: |mse - v| / v = {band:.3g} "
          f"(band {FLAGSHIP_BAND}), v {v:.6g} vs the engine's "
          f"{engine_v:.6g} ({v_rel:.3g}, bound 1e-2)")
    n_iter = int(n_iter)
    check(gb == {"gb_posterior": n_iter + 1, "gb_message": 0},
          f"flagship through the front door: prior kernel launches {gb} "
          f"for {n_iter} iterations (want one posterior per iteration and "
          "one at the readout)")
    print(f"flagship GLM N=10000 float32 through dispatch_solver "
          f"(SpectralVAMPSolver): n_iter={n_iter} mse={mse:.6g} v={v:.6g} "
          f"|mse-v|/v={band:.3e} v vs engine {v_rel:.3e} wall={wall:.3f} s "
          f"iterations/s={n_iter / wall:.1f} [{card}]")
    print_window("flagship, one instance", loop_window(
        lambda k: SpectralVAMPSolver(student, max_iter=k,
                                     tol=0.0).solve(student)), card)

    _, ys = batch_of_observations(torch, linear.W, LANES, False, seed=3)
    stacked = with_buffers(student, {(2, "y"): ys})
    what = f"flagship, solve_batch over {LANES} lanes"
    window = print_window(what, loop_window(
        lambda k: SpectralVAMPSolver(student, max_iter=k,
                                     tol=0.0).solve_batch(stacked)), card)
    batch_gb = {}
    post, n_iter, conv, batch_launches = batched_solve(
        torch, pl, what, lambda: solver.solve_info(stacked), LANES, card,
        window, gb=batch_gb)
    check(bool(conv.all()), f"{what}: {int((~conv).sum())} lanes did not "
                            "converge")
    iterations = int(n_iter.max())
    check(batch_gb == {"gb_posterior": iterations + 1, "gb_message": 0},
          f"{what}: prior kernel launches {batch_gb} for {iterations} "
          "iterations (want one posterior per iteration and one at the "
          "readout)")
    lanes_against_singles(torch, what, solver, student, 2, ys, post, n_iter)
    return ({k: launches[k] + batch_launches[k] for k in launches},
            {k: gb[k] + batch_gb[k] for k in gb})


def front_door_relu_net(torch, tt, pl, students, engine_r, card):
    """Phase 7: the relu net through dispatch_solver, one solve in float32
    and float64, then LANES lanes in float32 through MLVAMPSolver and through
    EPSolver. ``students``: {dtype name: (student, x0, linear)} of phase 4;
    ``engine_r``: the float64 engine's x posterior mean. Returns the
    launches of the path by kernel: pl_fused's, as a second dict the
    prior's message, one per sweep (checked), and as a third the loop
    finish's by solve, one per MLVAMPSolver loop iteration and none in
    EPSolver's (checked)."""
    from tramp_tpu_torch.channels import ReluChannel
    from tramp_tpu_torch.parallel import (
        EPSolver, MLVAMPSolver, dispatch_solver, with_buffers)
    total = dict.fromkeys(read_launches(pl), 0)
    gb_total = dict.fromkeys(read_gb_launches(), 0)
    finish = {}

    def add(launches, into=total):
        for k, v in launches.items():
            into[k] += v

    def add_gb(gb, sweeps, what):
        check(gb == {"gb_posterior": 0, "gb_message": sweeps},
              f"{what}: prior kernel launches {gb} for {sweeps} sweeps "
              "(want one message per sweep)")
        add(gb, gb_total)

    results, solvers = {}, {}
    for dname, (student, x0, _) in students.items():
        solver = solvers[dname] = dispatch_solver(student, **SOLVE)
        check(type(solver) is MLVAMPSolver,
              f"relu net: dispatch_solver gave {type(solver).__name__}")
        solver.solve(student)
        torch.cuda.synchronize()
        reset_launches(pl)
        t0 = time.perf_counter()
        post, n_iter, conv = solver.solve_info(student)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(pl)
        gb = read_gb_launches()
        finish[f"front_door_relu_net_{dname}"] = read_finish_launches()
        add(launches)
        n_iter = int(n_iter)
        add_gb(gb, n_iter, f"relu net {dname} through the front door")
        check(finish[f"front_door_relu_net_{dname}"] == n_iter,
              f"relu net {dname} through the front door: "
              f"{finish[f'front_door_relu_net_{dname}']} launches of "
              f"ml_vamp_finish for {n_iter} loop iterations")
        check(bool(conv) and launches["pl_forward_message"] == n_iter > 0
              and launches["pl_backward_message"] == n_iter
              and launches["pl_posterior"] == 0,
              f"relu net {dname} through the front door: conv={bool(conv)}, "
              f"launches {launches} for {n_iter} sweeps")
        r = post["x"]["r"].double().cpu()
        check(bool(torch.isfinite(r).all()), "non-finite x posterior")
        mse = float(((r - torch.as_tensor(x0)) ** 2).mean())
        v = float(post["x"]["v"])
        results[dname] = (mse, v, post["x"]["r"])
        print(f"relu net N=4096 {dname} through dispatch_solver "
              f"(MLVAMPSolver): n_iter={n_iter} mse={mse:.6g} v={v:.6g} "
              f"wall={wall:.3f} s sweeps/s={n_iter / wall:.1f} "
              f"launches={launches} [{card}]")
    (mse32, v32, _), (mse64, v64, r64) = results["float32"], results["float64"]
    v_rel, mse_rel = abs(v32 - v64) / v64, abs(mse32 - mse64) / mse64
    r_rel = rel_to_largest(torch, r64, engine_r)
    check(v_rel < V_MSE_BOUND and mse_rel < V_MSE_BOUND and r_rel < R_TOL,
          f"relu net through the front door, f32 vs f64: v {v_rel:.3g}, mse "
          f"{mse_rel:.3g} (bound {V_MSE_BOUND}); f64 vs the engine's fixed "
          f"point: r {r_rel:.3g} of the largest |r| (bound {R_TOL})")
    print(f"relu net through the front door, f32 vs f64: v rel err "
          f"{v_rel:.3e}, mse rel err {mse_rel:.3e} (bound {V_MSE_BOUND}); "
          f"f64 vs the engine's fixed point: r within {r_rel:.3e} of the "
          f"largest |r| (bound {R_TOL})")

    student, _, linear = students["float32"]
    print_window("relu net float32, one instance, MLVAMPSolver", loop_window(
        lambda k: MLVAMPSolver(student, damping=0.1, max_iter=k,
                               tol=0.0).solve(student)), card)
    likelihood = len(student.factors) - 1
    _, ys = batch_of_observations(torch, linear.W, LANES, True, seed=4)
    stacked = with_buffers(student, {(likelihood, "y"): ys})
    # The float32 stop metric (the relative change of r) has a rounding
    # floor that grows with the lanes that share W: the float32 GEMM over
    # 2048 lanes rounds five times as much as one instance's GEMV
    # (chip_stop_floor.py reads both and the floor with exact products).
    # Read it, then solve at a tolerance above it
    # (BATCH_TOL: every lane must converge and follow its single solve) and
    # at the tolerance of the single solves, which lies at or under the
    # floor: that run is the fixed work of max_iter sweeps, and its count of
    # converged lanes is printed, not checked.
    for label, model, lanes in (("one instance", student, None),
                                (f"{LANES} lanes", stacked, LANES)):
        last = stop_metric_floor(torch, solvers["float32"], model,
                                 lanes)[-1]
        lo, mid, hi = (float(last.min()), float(last.median()),
                       float(last.max()))
        print(f"relu net float32, {label}: the stop metric after 60 sweeps "
              f"is {lo:.3e} to {hi:.3e} over the lanes, median {mid:.3e} "
              f"(tol {SOLVE['tol']:g}, BATCH_TOL {BATCH_TOL:g}) [{card}]")
    windows = {
        "MLVAMPSolver": lambda k: MLVAMPSolver(
            student, damping=0.1, max_iter=k, tol=0.0).solve_batch(stacked),
        "EPSolver": lambda k: EPSolver(
            student, damping=0.1, max_iter=k, tol=0.0,
            rollback_increase=float("inf")).solve_batch(stacked)}
    windows = {
        name: print_window(f"relu net float32, {name}.solve_batch over "
                           f"{LANES} lanes", loop_window(run), card)
        for name, run in windows.items()}
    state = {}
    for tol in (BATCH_TOL, SOLVE["tol"]):
        above_floor = tol == BATCH_TOL
        kw = dict(SOLVE, tol=tol)
        solver = dispatch_solver(student, **kw)
        ep_solver = EPSolver(student, **kw)

        def ep_batch():
            post, state["ep"], n_iter, conv = ep_solver._solve_batch(
                stacked, None, None)
            return post, n_iter, conv

        posts = {}
        for name, run in (("MLVAMPSolver",
                           lambda: solver.solve_info(stacked)),
                          ("EPSolver", ep_batch)):
            what = (f"relu net float32, {name}.solve_batch over {LANES} "
                    f"lanes, tol {tol:g}")
            gb = {}
            post, n_iter, conv, launches = batched_solve(
                torch, pl, what, run, LANES, card, windows[name],
                warm_up=above_floor, gb=gb)
            add(launches)
            sweeps = int(n_iter.max())
            add_gb(gb, sweeps, what)
            finished = read_finish_launches()
            check(finished == (sweeps if name == "MLVAMPSolver" else 0),
                  f"{what}: {finished} launches of ml_vamp_finish for "
                  f"{sweeps} loop iterations")
            if name == "MLVAMPSolver":
                finish[f"front_door_relu_net_batched_tol{tol:g}"] = finished
            check(launches["pl_forward_message"] == sweeps
                  and launches["pl_backward_message"] == sweeps
                  and launches["pl_posterior"] == 0,
                  f"{what}: launches {launches} for {sweeps} sweeps (want "
                  "one of each message per sweep and no five-output kernel)")
            posts[name] = post
            if above_floor:
                check(bool(conv.all()), f"{what}: {int((~conv).sum())} "
                                        "lanes did not converge")
                if name == "MLVAMPSolver":
                    lanes_against_singles(torch, what, solver, student,
                                          likelihood, ys, post, n_iter)
        both = posts["MLVAMPSolver"]["x"]["r"], posts["EPSolver"]["x"]["r"]
        agree = float(((both[0] - both[1]).abs().amax(1)
                       / both[1].abs().amax(1)).median())
        check(agree < 1e-2, f"relu net, batched, tol {tol:g}: MLVAMPSolver "
              f"and EPSolver differ by {agree:.3g} of the largest |r| in the "
              "median lane")
        print(f"relu net float32, batched, tol {tol:g}: MLVAMPSolver and "
              f"EPSolver agree within {agree:.3e} of the largest |r| in the "
              "median lane")
    # the relu factor's posteriors of all lanes at EPSolver's fixed point:
    # the five-output kernel's path, two launches whatever the lanes
    from tramp_tpu_torch.algos.message_passing import slot, FWD, BWD
    eng, state = ep_solver.engine, state["ep"]
    i = next(i for i, n in enumerate(eng.nodes) if isinstance(n, ReluChannel))
    fwd = state[slot(eng.model.in_edges[i][0], FWD)]
    bwd = state[slot(eng.model.out_edges[i][0], BWD)]
    args = (fwd["a"], fwd["b"], bwd["a"], bwd["b"])
    reset_launches(pl)
    rx, vx = eng.nodes[i].compute_forward_posterior(*args)
    rz, vz = eng.nodes[i].compute_backward_posterior(*args)
    torch.cuda.synchronize()
    launches = read_launches(pl)
    add(launches)
    want = pl.pl_posterior_plain(*args, eng.nodes[i].region_specs)
    hold(torch, "relu posteriors of all lanes", ("rz", "vz", "rx", "vx"),
         (rz, vz, rx, vx),
         (want[0], want[1].mean(1, keepdim=True), want[2],
          want[3].mean(1, keepdim=True)), RTOL["float32"])
    check(launches["pl_posterior"] == 2 and rx.shape == LANE_SHAPE
          and vx.shape == vz.shape == (LANES, 1),
          f"relu posteriors of all lanes: launches {launches}, shapes "
          f"{tuple(rx.shape)}, {tuple(vx.shape)}")
    print(f"relu posteriors of {LANES} lanes: 2 launches of pl_posterior, "
          "inside the tolerance of phase 3")
    return total, gb_total, finish


def hold_se_shape(torch, pl, channel, card):
    """Phase 3, the shape of the batched SE integrand: SE_LANE_SHAPE in
    float64 with a precision per lane, and one instance's grid of the same
    channel. The five-output kernel against its plain version (rtol 1e-10
    with phase 3's floor), three lanes against their single launches (the
    same bits), and its times beside its bound. Returns (max abs error,
    {shape: row of times})."""
    specs = channel.region_specs
    lanes, n = SE_LANE_SHAPE
    dtype = torch.float64
    streams = ("rz", "vz", "rx", "vx", "logZ")
    rows, max_err = {}, 0.0
    for shape, args in ((SE_LANE_SHAPE, lane_inputs(torch, lanes, n, dtype, 5)),
                        (n, inputs(torch, n, dtype, 5))):
        what = f"pl_posterior {channel.name} float64 {shape}"
        got = pl.pl_posterior(*args, specs)
        want = pl.pl_posterior_plain(*args, specs)
        torch.cuda.synchronize()
        worst, err = hold(torch, what, streams, got, want, RTOL["float64"])
        max_err = max(max_err, err)
        if shape == SE_LANE_SHAPE:
            az, bz, ax, bx = args
            for i in (0, lanes // 2, lanes - 1):
                single = pl.pl_posterior(az[i, 0], bz[i], ax[i, 0], bx[i],
                                         specs)
                check(all(torch.equal(g[i], s_)
                          for g, s_ in zip(got, single)),
                      f"{what}: lane {i} differs from its single launch")
        del got, want

        def call():
            return pl.pl_posterior(*args, specs)

        def plain():
            return pl.pl_posterior_plain(*args, specs)

        kernels, device, _ = profiled(call, 5)
        check(device > 0, "torch.profiler shows no device time")
        one = shape != SE_LANE_SHAPE
        b_ms, by, moved = bound_ms("pl_posterior", specs, n, dtype,
                                   1 if one else lanes)
        rows[shape] = dict(
            device_ms=device, per_call_ms=per_call_ms(call, calls=5, reps=3),
            host_ms=host_ms(call, calls=20), bound_ms=b_ms, bound_by=by,
            plain_ms=per_call_ms(plain, calls=2, reps=3))
        row = rows[shape]
        print(f"SE integrand vs plain: {what} err/tol={worst:.2e} (rtol "
              f"{RTOL['float64']:g}); kernel time: device "
              f"{1e3 * device:.2f} us ({kernels:.0f} launches), per call "
              f"{1e3 * row['per_call_ms']:.2f} us, host "
              f"{1e3 * row['host_ms']:.2f} us, plain "
              f"{row['plain_ms']:.4f} ms, bound {1e3 * b_ms:.4f} us by {by} "
              f"({moved} B), share {100 * b_ms / device:.2f}% [{card}]")
    return max_err, rows


class RegionPathCounter:
    """Counts, while active, the calls of the plain five-output posterior
    and of the region-by-region moments (``LinearRegion``): the eager path
    that the kernel replaces on the card."""
    METHODS = ("backward_mean", "backward_variance", "forward_mean",
               "forward_variance", "log_partitions")

    def __init__(self, pl):
        from tramp_tpu_torch.utils.linear_region import LinearRegion
        self.pl, self.region, self.calls, self.saved = pl, LinearRegion, 0, {}

    def _counting(self, fn):
        def counted(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)
        return counted

    def __enter__(self):
        self.saved = {m: getattr(self.region, m) for m in self.METHODS}
        self.saved["plain"] = self.pl.pl_posterior_plain
        for m in self.METHODS:
            setattr(self.region, m, self._counting(self.saved[m]))
        self.pl.pl_posterior_plain = self._counting(self.saved["plain"])
        return self

    def __exit__(self, *exc):
        self.pl.pl_posterior_plain = self.saved.pop("plain")
        for m, fn in self.saved.items():
            setattr(self.region, m, fn)


def timed_solve(torch, run):
    "Wall seconds of ``run()`` on a drained device."
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def se_v(se, ids):
    return {id: float(se.get_variable_data(id)["v"].double().mean())
            for id in ids}


def phase_9a_goldens(torch, tt, card):
    from tramp_tpu_torch.algos import CustomInit
    for alpha, v_ref, rtol in CS_SE_ROWS + [CS_UNIVERSALITY_ROW]:
        model = tt.glm_state_evolution(alpha=alpha, prior_rho=0.25, **CS)
        se = tt.StateEvolution(model)
        se.iterate(max_iter=200,
                   initializer=CustomInit(a_init=[("x", "bwd", 0)]))
        v = se.get_variable_data("x")["v"]
        check(v.device.type == "cuda" and v.dtype == torch.float64,
              f"SE golden: v is {v.dtype} on {v.device}")
        err = abs(float(v) - v_ref) / v_ref
        check(err <= rtol, f"SE golden alpha={alpha}: v={float(v):.12g}, "
              f"pinned {v_ref:.12g}, rel err {err:.3g} (rtol {rtol:g})")
        print(f"SE golden on the card: alpha={alpha:.6f} rho=0.25 "
              f"n_iter={se.n_iter} v={float(v):.12g} pinned {v_ref:.12g} "
              f"rel err {err:.3e} (rtol {rtol:g}) [{card}]")


def cs_grid():
    """The 1030-point grid of the compressed-sensing GLM (bench.py:742-754,
    plus the golden alphas): (alphas, rhos, the keywords of
    ``se_phase_grid_records``)."""
    golden_alphas = [a for a, _, _ in CS_SE_ROWS]
    alphas = sorted(set(np.linspace(0.02, 2.0, 100)) | set(golden_alphas))
    rhos = list(np.linspace(0.05, 0.95, 10))
    grid = {"alpha": alphas, "prior_rho": rhos}
    return alphas, rhos, dict(grid_kwargs=grid, ids=("x",), a0=0.0,
                              max_iter=200, tol=1e-6, **CS)


def phase_9b_grid(torch, tt, pl, card):
    """The 1030-point grid of the compressed-sensing GLM and the 19 critical
    lines. Returns the launches of the path (none: it runs no kernel)."""
    from tramp_tpu_torch.algos import CustomInit
    from tramp_tpu_torch.experiments import find_critical_alpha_batched
    from tramp_tpu_torch.parallel import (
        SESolver, grid_combos, se_phase_grid_records, stack_models)
    alphas, rhos, kw = cs_grid()
    grid = kw["grid_kwargs"]
    se_phase_grid_records(tt.glm_state_evolution, **kw)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(pl)
    t0 = time.perf_counter()
    records = se_phase_grid_records(tt.glm_state_evolution, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    peak = torch.cuda.max_memory_allocated()
    n = len(records)
    check(n == len(alphas) * len(rhos) == 1030, f"SE grid: {n} records")
    v = np.array([r["v"] for r in records])
    n_iter = np.array([r["n_iter"] for r in records])
    check(np.isfinite(v).all() and (v > 0).all(),
          f"SE grid: {int((~np.isfinite(v)).sum())} values are not finite")
    for alpha, v_ref, rtol in CS_SE_ROWS:
        row = [r for r in records if r["alpha"] == alpha
               and abs(r["prior_rho"] - 0.25) < 1e-12]
        check(len(row) == 1, f"SE grid: {len(row)} rows at alpha={alpha}")
        err = abs(row[0]["v"] - v_ref) / v_ref
        check(err <= rtol, f"SE grid, golden alpha={alpha}: v="
              f"{row[0]['v']:.12g}, pinned {v_ref:.12g} (rtol {rtol:g})")
        print(f"SE grid, golden row alpha={alpha:.6f}: v={row[0]['v']:.12g} "
              f"rel err {err:.3e} (rtol {rtol:g})")
    # three lanes against their single solves
    combos = grid_combos(grid)
    models = [tt.glm_state_evolution(
        **{k: val.item() for k, val in c.items()}, **CS) for c in combos]
    solver = SESolver(models[0], max_iter=200, tol=1e-6)
    init = CustomInit(a_init=[("x", "bwd", 0.0)])
    for lane in (0, n // 2, n - 1):
        post, n_1 = solver.solve(models[lane], init)
        v_1 = float(post["x"]["v"])
        err = abs(v[lane] - v_1) / v_1
        check(err <= 1e-10 and int(n_1) == n_iter[lane],
              f"SE grid: lane {lane} v={v[lane]:.15g} n_iter={n_iter[lane]}, "
              f"single solve v={v_1:.15g} n_iter={int(n_1)}")
        print(f"SE grid: lane {lane} vs its single solve: v rel err "
              f"{err:.3e} (rtol 1e-10), n_iter {n_iter[lane]} both")
    stacked = stack_models(models)
    window = print_window(
        f"SE grid of the compressed-sensing GLM, {n} lanes", loop_window(
            lambda k: SESolver(models[0], max_iter=k, tol=0.0).solve_batch(
                stacked, init)), card)
    iterations = int(n_iter.max())
    solve_wall = timed_solve(torch, lambda: solver.solve_batch(stacked, init))
    print(f"SE grid of the compressed-sensing GLM: {n} points in one "
          f"solve_batch, {iterations} iterations of the loop (per lane "
          f"{int(n_iter.min())} to {iterations}, mean {n_iter.mean():.2f}), "
          f"{wall:.4f} s with building and stacking the models, "
          f"{n / wall:.1f} points/s; the solve alone {solve_wall:.4f} s, "
          f"{1e3 * solve_wall / iterations:.4f} ms per iteration, of which "
          f"{window['device_ms']:.4f} ms on the device (busy "
          f"{100 * window['device_ms'] * iterations / (1e3 * solve_wall):.2f}"
          f"%), peak memory {peak} B, launches {launches} [{card}]")
    check(not any(launches.values()), f"SE grid ran kernels: {launches}")

    t0 = time.perf_counter()
    lines = find_critical_alpha_batched(
        id="x", a0=0, mse_criterion="perfect", alpha_min=1e-5, alpha_max=2.0,
        alpha_tol=ALPHA_TOL, model_builder=tt.glm_state_evolution,
        grid_kwargs={"prior_rho": list(np.linspace(0.05, 0.95, 19))}, **CS)
    wall = time.perf_counter() - t0
    off = np.abs(np.asarray(lines) - np.asarray(CS_CRITICAL_REF))
    check(lines.shape == (19,) and (off <= ALPHA_TOL).all(),
          f"critical lines: off the pinned values by up to {off.max():.3g} "
          f"(alpha_tol {ALPHA_TOL})")
    print(f"critical lines of compressed sensing, 19 lines in one batched "
          f"bisection: {wall:.3f} s, max |alpha - pinned| = {off.max():.3e} "
          f"(alpha_tol {ALPHA_TOL}), {int((off <= 1e-12).sum())} of 19 "
          f"bit-equal to the pinned values [{card}]")
    return launches


def relu_channel_model(tt, alpha, prior_rho):
    "prior -> Marchenko-Pastur -> relu -> Gaussian likelihood, SE only."
    from tramp_tpu_torch.channels import MarchenkoPasturChannel, ReluChannel
    from tramp_tpu_torch.likelihoods import GaussianLikelihood
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    return (GaussBernoulliPrior(size=1, rho=prior_rho) @ tt.V(id="x")
            @ MarchenkoPasturChannel(alpha) @ tt.V(id="z") @ ReluChannel()
            @ tt.V(id="a") @ GaussianLikelihood(y=None, var=NOISE)).to_model()


def phase_9c_kernel_on_the_se_path(torch, tt, pl, student, linear, card):
    """The five-output kernel as the SE integrand, one instance and 1024
    lanes. Returns (launches by path, v of the student's SE by variable)."""
    from tramp_tpu_torch.parallel import (
        SESolver, grid_combos, se_phase_grid_records, stack_models)
    ids = ("x", "z", "a")
    # one instance: the relu-net student of phase 4, card against CPU
    tt.StateEvolution(student).iterate(max_iter=200)         # warm-up
    torch.cuda.synchronize()
    reset_launches(pl)
    with RegionPathCounter(pl) as eager:
        t0 = time.perf_counter()
        se = tt.StateEvolution(student).iterate(max_iter=200)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    one = read_launches(pl)
    check(one == {"pl_posterior": 2 * se.n_iter, "pl_forward_message": 0,
                  "pl_backward_message": 0} and se.n_iter > 1
          and eager.calls == 0,
          f"SE of the relu-net student: launches {one} for {se.n_iter} "
          f"sweeps (want 2 of pl_posterior per sweep and no message), "
          f"{eager.calls} calls of the region-by-region path (want 0)")
    svd = tuple(t.cpu() for t in (linear.U, linear.s, linear.V.T))
    cpu_student, _, _ = relu_net(torch, tt, torch.float64, device="cpu",
                                 svd=svd)
    with RegionPathCounter(pl) as cpu_eager:
        cpu_se = tt.StateEvolution(cpu_student).iterate(max_iter=200)
    v, v_cpu = se_v(se, ids), se_v(cpu_se, ids)
    err = worst_of(abs(v[id] - v_cpu[id]) / v_cpu[id] for id in ids)
    check(se.n_iter == cpu_se.n_iter and err <= 1e-8
          and cpu_se.device.type == "cpu" and cpu_eager.calls > 0
          and read_launches(pl) == one,
          f"SE of the relu-net student: card n_iter {se.n_iter} vs CPU "
          f"{cpu_se.n_iter}, v rel err {err:.3g} (rtol 1e-8), the CPU run "
          f"made {cpu_eager.calls} calls of the plain version")
    kernels, device, wall_ms = profiled(
        lambda: tt.StateEvolution(student).iterate(max_iter=10, tol=0.0), 1)
    print(f"SE of the relu-net student N=4096 float64: n_iter={se.n_iter} "
          f"v={v} wall={wall:.3f} s sweeps/s={se.n_iter / wall:.1f} "
          f"launches={one}, region-by-region path {eager.calls} calls; card "
          f"vs CPU (plain version): n_iter equal, v rel err {err:.3e} (rtol "
          f"1e-8); torch.profiler over 10 sweeps with set-up: "
          f"{kernels / 10:.1f} kernels per sweep, device "
          f"{device / 10:.4f} ms of {wall_ms / 10:.4f} ms per sweep, busy "
          f"{100 * device / wall_ms:.2f}% [{card}]")

    # 1024 lanes: the relu-channel model over an (alpha, rho) grid
    grid = {"alpha": list(np.linspace(0.1, 2.0, 64)),
            "prior_rho": list(np.linspace(0.05, 0.95, 16))}

    def relu_model(alpha, prior_rho):
        return relu_channel_model(tt, alpha, prior_rho)

    kw = dict(grid_kwargs=grid, ids=ids, max_iter=200, tol=1e-6)
    se_phase_grid_records(relu_model, **dict(kw, max_iter=3))    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(pl)
    with RegionPathCounter(pl) as eager:
        t0 = time.perf_counter()
        records = se_phase_grid_records(relu_model, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    batch = read_launches(pl)
    peak = torch.cuda.max_memory_allocated()
    lanes = SE_LANE_SHAPE[0]
    by_id = {id: np.array([r["v"] for r in records if r["id"] == id])
             for id in ids}
    n_iter = np.array([r["n_iter"] for r in records if r["id"] == "x"])
    check(all(a.shape == (lanes,) and np.isfinite(a).all()
              for a in by_id.values()), "SE of the relu-channel grid: a v "
          "is missing or not finite")
    iterations = int(n_iter.max())
    check(batch == {"pl_posterior": 2 * iterations, "pl_forward_message": 0,
                    "pl_backward_message": 0} and eager.calls == 0,
          f"SE of the relu-channel grid: launches {batch} for {iterations} "
          f"iterations (want 2 of pl_posterior per iteration), "
          f"{eager.calls} calls of the region-by-region path (want 0)")
    combos = grid_combos(grid)
    models = [relu_model(**{k: val.item() for k, val in c.items()})
              for c in combos]
    solver = SESolver(models[0], max_iter=200, tol=1e-6)
    for lane in (0, lanes // 2, lanes - 1):
        post, n_1 = solver.solve(models[lane])
        err = worst_of(abs(by_id[id][lane] - float(post[id]["v"]))
                       / float(post[id]["v"]) for id in ids)
        check(err <= 1e-8 and int(n_1) == n_iter[lane],
              f"SE of the relu-channel grid: lane {lane} is {err:.3g} off "
              f"its single solve (rtol 1e-8), n_iter {n_iter[lane]} vs "
              f"{int(n_1)}")
        print(f"SE of the relu-channel grid: lane {lane} vs its single "
              f"solve: v of x, z, a within {err:.3e} (rtol 1e-8), n_iter "
              f"{n_iter[lane]} both")
    stacked = stack_models(models)
    window = print_window(
        f"SE of the relu-channel model, {lanes} lanes", loop_window(
            lambda k: SESolver(models[0], max_iter=k,
                               tol=0.0).solve_batch(stacked), 5), card)
    solve_wall = timed_solve(torch, lambda: solver.solve_batch(stacked))
    print(f"SE of the relu-channel model: {lanes} points in one "
          f"solve_batch, {iterations} iterations of the loop (per lane "
          f"{int(n_iter.min())} to {iterations}, mean {n_iter.mean():.2f}), "
          f"{wall:.4f} s with building and stacking the models, "
          f"{lanes / wall:.1f} points/s; the solve alone {solve_wall:.4f} s, "
          f"{1e3 * solve_wall / iterations:.4f} ms per iteration, of which "
          f"{window['device_ms']:.4f} ms on the device (busy "
          f"{100 * window['device_ms'] * iterations / (1e3 * solve_wall):.2f}"
          f"%), peak memory {peak} B ({peak / 2**30:.3f} GiB), launches "
          f"{batch} [{card}]")
    return {"se_relu_student": one, "se_relu_channel_grid": batch}, v


def phase_9d_ep_against_se(torch, tt, flagship_student, flagship_v, relu_v_se,
                           relu_ep, card):
    se = tt.StateEvolution(flagship_student).iterate(max_iter=200)
    v_se = float(se.get_variable_data("x")["v"])
    gap = abs(flagship_v - v_se) / v_se
    check(gap < FLAGSHIP_BAND,
          f"flagship: |v_EP - v_SE| / v_SE = {gap:.3g} (band "
          f"{FLAGSHIP_BAND})")
    print(f"EP against SE, flagship GLM N=10000: v_SE={v_se:.6g} "
          f"(n_iter={se.n_iter}) v_EP={flagship_v:.6g} |v_EP-v_SE|/v_SE="
          f"{gap:.3e} (band {FLAGSHIP_BAND}) [{card}]")
    mse, v_ep = relu_ep
    print(f"EP against SE, relu net N=4096 float64 (readings, no limit): "
          f"v_SE={relu_v_se['x']:.6g} v_EP={v_ep:.6g} mse={mse:.6g} "
          f"|v_EP-v_SE|/v_SE={abs(v_ep - relu_v_se['x']) / relu_v_se['x']:.3e}"
          f" |mse-v_SE|/v_SE={abs(mse - relu_v_se['x']) / relu_v_se['x']:.3e}"
          f" [{card}]")



# -- phase 10: the priors, likelihoods and GLMs of Queue 1 item 3 ------------
# tests/test_golden_csv.py, values and tolerances copied: the relu GLM
# (:29-41, a0 = 0, rho = 0.4, rtol 2e-3, atol 1e-8)
RELU_ROWS = [(0.02, 3.934630e-01), (0.68, 1.447860e-01),
             (1.34, 8.171982e-07), (2.00, 1.498413e-07)]
# sign retrieval (:47-66, (a0, alpha, v), rho = 0.4, rtol 5e-2, atol 1e-9)
SGN_RETRIEVAL_ROWS = [
    (0.1, 0.02, 4.000000e-01), (0.1, 0.42, 3.999986e-01),
    (0.1, 1.20, 1.173827e-11), (1000.0, 0.02, 4.000000e-01),
    (1000.0, 0.82, 3.139240e-08), (1000.0, 1.20, 4.906084e-11)]
# the door (:72-85, binary prior p_pos = 0.51, width 0.5, a0 = 0.1,
# EarlyStopping(max_increase=0.1), rtol 2e-3, atol 1e-9)
DOOR_ROWS = [(0.55, 9.994379e-01), (1.35, 9.986345e-01),
             (2.20, 1.000000e-11), (3.00, 1.000000e-11)]
# phase retrieval (:92-106, (alpha, rho, v), a0 = 0.1, rtol 2e-3, atol 1e-9)
PHASE_RETRIEVAL_ROWS = [
    (0.02, 0.4, 3.999999999984001e-01), (0.78, 0.4, 3.9999888831043146e-01),
    (1.48, 0.4, 4.0751071795360275e-07), (2.98, 0.4, 9.331278199196563e-08),
    (0.98, 0.6, 5.999765079941322e-01), (2.58, 0.6, 1.701603759962448e-07)]
# the perceptron (:115-127, (alpha, v, rtol), p_pos = 0.25, a0 = 0,
# atol 1e-8)
PERCEPTRON_SE_ROWS = [
    (0.02, 7.414219343897764e-01, 1e-4), (0.50, 5.313722052339810e-01, 1e-3),
    (1.00, 3.107288020924469e-01, 2e-3), (1.50, 2.199742009303205e-09, 1.0)]
# phase retrieval, EP against SE (:237-253, rho = 0.5, mean = 0.01, no
# informed start, damping 0.3, EarlyStopping(wait_increase=10), rtol 1e-5)
PR_EP_VS_SE_ROWS = [(0.02, 5.00024499743053e-01),
                    (0.20, 5.000188335458711e-01),
                    (0.40, 5.000086073600495e-01)]
# critical lines (:182-230)
RELU_CRITICAL_REF = [0.18799734130859375, 0.3354575415039062,
                     0.4682693774414063, 0.5913156372070312]
SGN_CRITICAL_CASES = [
    ("random", [0.5458062329101563, 0.5159236694335938]),
    ("perfect", [0.5458062329101563, 0.5504936938476563])]
DOOR_CRITICAL_REF = [2.5458129882812504]
# the perceptron of bench.py:504-533
PERCEPTRON = dict(N=1000, alpha=1.0, p_pos=0.25, seed=21)
EP_SE_BAND = 0.25      # phase 9d's band of |v_EP - v_SE| / v_SE


def se_families():
    """The golden families of tests/test_golden_csv.py as batched SE solves:
    (name, shared builder keywords, per-lane builder keywords, per-lane a0
    (None: the default start), rows' (v, rtol, atol), SESolver keywords,
    iterate keywords of the golden test's own call, the lane also solved
    singly)."""
    def early_stop(**kw):
        from tramp_tpu_torch.algos import EarlyStopping
        return lambda: EarlyStopping(**kw)

    gb = dict(prior_type="gauss_bernoulli", prior_mean=0.0)
    return [
        ("relu", dict(gb, output_type="relu", prior_rho=0.4),
         [dict(alpha=a) for a, _ in RELU_ROWS], [0.0] * 4,
         [(v, 2e-3, 1e-8) for _, v in RELU_ROWS], {}, {}, 1),
        ("sign retrieval", dict(gb, output_type="abs", prior_rho=0.4),
         [dict(alpha=a) for _, a, _ in SGN_RETRIEVAL_ROWS],
         [a0 for a0, _, _ in SGN_RETRIEVAL_ROWS],
         [(v, 5e-2, 1e-9) for _, _, v in SGN_RETRIEVAL_ROWS], {}, {}, 3),
        ("door", dict(prior_type="binary", output_type="door",
                      output_width=0.5, prior_p_pos=0.51),
         [dict(alpha=a) for a, _ in DOOR_ROWS], [0.1] * 4,
         [(v, 2e-3, 1e-9) for _, v in DOOR_ROWS],
         dict(rollback_increase=0.1),
         dict(callback=early_stop(max_increase=0.1)), 0),
        ("phase retrieval", dict(gb, output_type="modulus"),
         [dict(alpha=a, prior_rho=r) for a, r, _ in PHASE_RETRIEVAL_ROWS],
         [0.1] * 6, [(v, 2e-3, 1e-9) for _, _, v in PHASE_RETRIEVAL_ROWS],
         {}, {}, 1),
        ("perceptron", dict(prior_type="binary", output_type="sgn",
                            prior_p_pos=0.25),
         [dict(alpha=a) for a, _, _ in PERCEPTRON_SE_ROWS], [0.0] * 4,
         [(v, rtol, 1e-8) for _, v, rtol in PERCEPTRON_SE_ROWS], {}, {}, 1),
        ("phase retrieval EP vs SE",
         dict(prior_type="gauss_bernoulli", output_type="modulus",
              prior_rho=0.5, prior_mean=0.01),
         [dict(alpha=a) for a, _ in PR_EP_VS_SE_ROWS], None,
         [(v, 1e-5, 0.0) for _, v in PR_EP_VS_SE_ROWS],
         dict(damping=0.3, wait_increase=10),
         dict(damping=0.3, callback=early_stop(wait_increase=10)), 1),
    ]


def phase_10a_goldens(torch, tt, pl, card):
    """Every golden row of the new families on the card, each family one
    SESolver.solve_batch with its rows as lanes (alpha, rho, p_pos per
    lane, a0 through the per-lane initializer list); one lane per family
    against the golden test's own call, StateEvolution.iterate with its
    callback (v to rtol 1e-10, equal n_iter). Returns (launches of the
    path, v of the perceptron's alpha = 1 row, seconds by family)."""
    from tramp_tpu_torch.algos import CustomInit
    from tramp_tpu_torch.parallel import SESolver, stack_models
    reset_launches(pl)
    perceptron_v, seconds, rows = None, {}, 0
    for (name, shared, lanes, a0s, refs, solver_kw, iterate_kw,
         single) in se_families():
        models = [tt.glm_state_evolution(**shared, **kw) for kw in lanes]
        stacked = stack_models(models)
        inits = None if a0s is None else [
            CustomInit(a_init=[("x", "bwd", a0)]) for a0 in a0s]
        solver = SESolver(models[0], max_iter=200, tol=1e-6, **solver_kw)
        out = {}
        wall = timed_solve(torch, lambda: out.update(
            res=solver.solve_batch(stacked, inits)))
        post, n_iter = out["res"]
        v = post["x"]["v"].double().cpu().numpy()
        n_iter = n_iter.cpu().numpy()
        check(post["x"]["v"].device.type == "cuda" and v.shape == (
            len(lanes),), f"{name}: v of shape {v.shape}")
        for i, ((v_ref, rtol, atol), kw) in enumerate(zip(refs, lanes)):
            err = abs(v[i] - v_ref)
            check(np.isfinite(v[i]) and err <= atol + rtol * abs(v_ref),
                  f"SE golden, {name} {kw} a0={None if a0s is None else a0s[i]}"
                  f": v={v[i]:.12g}, pinned {v_ref:.12g} (rtol {rtol:g}, "
                  f"atol {atol:g})")
            print(f"SE golden on the card, {name} {kw}"
                  f"{'' if a0s is None else f' a0={a0s[i]:g}'}: "
                  f"n_iter={n_iter[i]} v={v[i]:.12g} pinned {v_ref:.12g} "
                  f"|v - pinned| = {err:.3e} (bound "
                  f"{atol + rtol * abs(v_ref):.3e}) [{card}]")
            rows += 1
        kw = {k: (f() if k == "callback" else f)
              for k, f in iterate_kw.items()}
        if a0s is not None:
            kw["initializer"] = CustomInit(a_init=[("x", "bwd",
                                                    a0s[single])])
        se = tt.StateEvolution(models[single]).iterate(max_iter=200, **kw)
        v_1 = float(se.get_variable_data("x")["v"])
        err = abs(v[single] - v_1) / v_1
        check(err <= 1e-10 and se.n_iter == n_iter[single],
              f"{name}: lane {single} v={v[single]:.15g} n_iter="
              f"{n_iter[single]}, StateEvolution.iterate v={v_1:.15g} "
              f"n_iter={se.n_iter}")
        seconds[name] = wall
        iterations = int(n_iter.max())
        window = print_window(f"SE goldens of {name}, {len(lanes)} lanes",
                              loop_window(lambda k: SESolver(
                                  models[0], max_iter=k, tol=0.0,
                                  **dict(solver_kw, rollback_increase=float(
                                      "inf"))).solve_batch(stacked, inits)),
                              card)
        print(f"SE goldens of {name}: {len(lanes)} rows in one solve_batch, "
              f"{wall:.3f} s, {iterations} iterations of the loop, "
              f"{1e3 * wall / iterations:.4f} ms per iteration, of which "
              f"{window['device_ms']:.4f} ms on the device (busy "
              f"{100 * window['device_ms'] * iterations / (1e3 * wall):.2f}"
              f"%); lane {single} against StateEvolution.iterate: v rel err "
              f"{err:.3e} (rtol 1e-10), n_iter {se.n_iter} both [{card}]")
        if name == "perceptron":
            perceptron_v = float(v[[a for a, _, _ in
                                    PERCEPTRON_SE_ROWS].index(1.0)])
    launches = read_launches(pl)
    check(rows == 27 and not any(launches.values()),
          f"SE goldens: {rows} rows, launches {launches}")
    return launches, perceptron_v, seconds


def phase_10b_critical_lines(torch, tt, pl, card):
    """The relu, sign-retrieval and door critical lines through
    find_critical_alpha_batched, within ALPHA_TOL of the pinned values.
    Returns (launches of the path, seconds by family)."""
    from tramp_tpu_torch.experiments import find_critical_alpha_batched
    gb = dict(prior_type="gauss_bernoulli", prior_mean=0.0)
    searches = [
        ("relu", RELU_CRITICAL_REF, dict(
            a0=0, mse_criterion="perfect", alpha_min=1e-5, alpha_max=2.0,
            grid_kwargs={"prior_rho": [0.05, 0.1, 0.15, 0.2]},
            output_type="relu", **gb))]
    for criterion, ref in SGN_CRITICAL_CASES:
        searches.append((f"sign retrieval {criterion}", ref, dict(
            a0=0.1, mse_criterion=criterion, alpha_min=1e-5, alpha_max=1.2,
            grid_kwargs={"prior_rho": [0.05, 0.15]}, output_type="abs",
            **gb)))
    searches.append(("door", DOOR_CRITICAL_REF, dict(
        a0=0.1, mse_criterion="random", alpha_min=0.1, alpha_max=3.0,
        grid_kwargs={"prior_p_pos": [0.51]}, prior_type="binary",
        output_type="door", output_width=0.25)))
    reset_launches(pl)
    seconds = {}
    for name, ref, kw in searches:
        t0 = time.perf_counter()
        lines = find_critical_alpha_batched(
            id="x", alpha_tol=ALPHA_TOL, model_builder=tt.glm_state_evolution,
            **kw)
        seconds[name] = time.perf_counter() - t0
        off = np.abs(np.asarray(lines) - np.asarray(ref))
        check(lines.shape == (len(ref),) and (off <= ALPHA_TOL).all(),
              f"critical lines of {name}: {lines.tolist()}, pinned {ref} "
              f"(alpha_tol {ALPHA_TOL})")
        print(f"critical lines of {name}, {len(ref)} in one batched "
              f"bisection: {seconds[name]:.3f} s, max |alpha - pinned| = "
              f"{off.max():.3e} (alpha_tol {ALPHA_TOL}), "
              f"{int((off <= 1e-12).sum())} of {len(ref)} bit-equal to the "
              f"pinned values [{card}]")
    launches = read_launches(pl)
    check(not any(launches.values()), f"critical lines ran kernels: "
                                      f"{launches}")
    return launches, seconds


def perceptron_student(torch, tt, dtype, N=PERCEPTRON["N"], device="cuda",
                       svd=None):
    """The perceptron of bench.py:504-533: binary prior (p_pos), W, sign
    output, data from np.random.RandomState(seed). Returns (student,
    teacher x, linear channel)."""
    from tramp_tpu_torch.channels import LinearChannel
    from tramp_tpu_torch.likelihoods import SgnLikelihood
    from tramp_tpu_torch.priors import BinaryPrior
    M = int(PERCEPTRON["alpha"] * N)
    rng = np.random.RandomState(PERCEPTRON["seed"])
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = np.where(rng.rand(N) < PERCEPTRON["p_pos"], 1.0, -1.0)
    y = np.sign(W @ x0)
    y[y == 0] = 1.0
    linear = LinearChannel(W, name="W", svd=svd, device=device, dtype=dtype)
    student = (
        BinaryPrior(size=N, p_pos=PERCEPTRON["p_pos"], device=device,
                    dtype=dtype)
        @ tt.V(id="x") @ linear @ tt.V(id="z")
        @ SgnLikelihood(y=y, device=device, dtype=dtype)).to_model()
    return student, x0, linear


def perceptron_batch(torch, W, lanes, seed):
    """One teacher and observation per lane, drawn on the card: x = +-1
    with P(+1) = p_pos, y = sgn(W x) (0 counted as +1)."""
    g = torch.Generator(device=W.device).manual_seed(seed)
    kw = dict(generator=g, device=W.device, dtype=W.dtype)
    x = torch.where(torch.rand((lanes, W.shape[1]), **kw)
                    < PERCEPTRON["p_pos"], 1.0, -1.0).to(W.dtype)
    y = torch.sign(x @ W.T)
    return x, torch.where(y == 0, 1.0, y)


def phase_10c_perceptron(torch, tt, pl, v_se, card):
    """The perceptron's EP path: EPSolver and dispatch_solver in float32 and
    float64, f32 against f64, EP against SE, then LANES lanes in float32.
    Returns the launches of the path."""
    from tramp_tpu_torch.parallel import (
        EPSolver, MLVAMPSolver, dispatch_solver, with_buffers)
    kw = dict(damping=0.1, max_iter=500, tol=1e-6)
    reset_launches(pl)
    results, students = {}, {}
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        student, x0, linear = students[dname] = perceptron_student(
            torch, tt, dtype)
        for name, make in (("EPSolver", EPSolver),
                           ("dispatch_solver", dispatch_solver)):
            solver = make(student, **kw)
            if name == "dispatch_solver":
                check(type(solver) is MLVAMPSolver,
                      f"perceptron: dispatch_solver gave "
                      f"{type(solver).__name__}")
            solver.solve(student)                       # warm-up
            out = {}
            wall = timed_solve(torch, lambda: out.update(
                res=solver.solve_info(student)))
            post, n_iter, conv = out["res"]
            r = post["x"]["r"].double().cpu().numpy()
            v = float(post["x"]["v"])
            check(bool(conv) and np.isfinite(r).all() and r.shape == x0.shape,
                  f"perceptron {dname} {name}: conv={bool(conv)}")
            mse = float(np.mean((r - x0) ** 2))
            results[dname, name] = (mse, v)
            print(f"perceptron N={PERCEPTRON['N']} {dname} through {name} "
                  f"({type(solver).__name__}): n_iter={int(n_iter)} "
                  f"mse={mse:.6g} v={v:.6g} wall={wall:.3f} s "
                  f"iterations/s={int(n_iter) / wall:.1f} [{card}]")
    for name in ("EPSolver", "dispatch_solver"):
        (mse32, v32), (mse64, v64) = (results["float32", name],
                                      results["float64", name])
        v_rel, mse_rel = abs(v32 - v64) / v64, abs(mse32 - mse64) / mse64
        check(v_rel < V_MSE_BOUND and mse_rel < V_MSE_BOUND,
              f"perceptron {name} f32 vs f64: v {v_rel:.3g}, mse "
              f"{mse_rel:.3g} (bound {V_MSE_BOUND})")
        print(f"perceptron {name}, f32 vs f64: v rel err {v_rel:.3e}, mse "
              f"rel err {mse_rel:.3e} (bound {V_MSE_BOUND})")
    v_ep = results["float64", "EPSolver"][1]
    gap = abs(v_ep - v_se) / v_se
    check(gap < EP_SE_BAND, f"perceptron: |v_EP - v_SE| / v_SE = {gap:.3g} "
                            f"(band {EP_SE_BAND})")
    print(f"EP against SE, perceptron N={PERCEPTRON['N']} alpha=1: v_SE="
          f"{v_se:.6g} v_EP={v_ep:.6g} |v_EP-v_SE|/v_SE={gap:.3e} (band "
          f"{EP_SE_BAND}) [{card}]")
    single = read_launches(pl)
    student = students["float32"][0]
    print_window("perceptron float32, one instance, MLVAMPSolver",
                 loop_window(lambda k: MLVAMPSolver(
                     student, damping=0.1, max_iter=k, tol=0.0).solve(
                         student)), card)

    # LANES lanes on one W, float32, at BATCH_TOL (the float32 stop
    # metric's floor with many lanes on one operator)
    student, _, linear = students["float32"]
    xs, ys = perceptron_batch(torch, linear.W, LANES, seed=5)
    stacked = with_buffers(student, {(2, "y"): ys})
    bkw = dict(kw, tol=BATCH_TOL)
    solver, ep_solver = dispatch_solver(student, **bkw), \
        EPSolver(student, **bkw)
    total = dict(single)
    for name, run, window in (
            ("MLVAMPSolver", lambda: solver.solve_info(stacked),
             lambda k: MLVAMPSolver(student, damping=0.1, max_iter=k,
                                    tol=0.0).solve_batch(stacked)),
            ("EPSolver", lambda: _ep_batch(ep_solver, stacked),
             lambda k: EPSolver(student, damping=0.1, max_iter=k, tol=0.0,
                                rollback_increase=float("inf")).solve_batch(
                                    stacked))):
        what = (f"perceptron float32, {name}.solve_batch over {LANES} lanes, "
                f"tol {BATCH_TOL:g}")
        w = print_window(what, loop_window(window), card)
        post, n_iter, conv, launches = batched_solve(
            torch, pl, what, run, LANES, card, w)
        for k, v in launches.items():
            total[k] += v
        check(bool(conv.all()), f"{what}: {int((~conv).sum())} lanes did not "
                                "converge")
        mse = ((post["x"]["r"] - xs) ** 2).mean(1)
        print(f"{what}: mse per lane {float(mse.min()):.4g} to "
              f"{float(mse.max()):.4g}, median {float(mse.median()):.4g}")
        if name == "MLVAMPSolver":
            lanes_against_singles(torch, what, solver, student, 2, ys, post,
                                  n_iter)
    check(not any(total.values()), f"the perceptron ran kernels: {total}")
    return total


def _ep_batch(ep_solver, stacked):
    "EPSolver's batched solve as (post, n_iter, conv)."
    post, _, n_iter, conv = ep_solver._solve_batch(stacked, None, None)
    return post, n_iter, conv


def phase_10d_sign_retrieval_and_relu(torch, tt, pl, card, N=4096):
    """Sign retrieval (abs output) and the relu GLM through glm_generative
    and channel2likelihood, float64, EP from an informed start (a0 = 1000
    and b = a0 times the teacher on x) against SE from a0 = 1000. Returns
    the launches of the path."""
    from tramp_tpu_torch.algos import CustomInit
    from tramp_tpu_torch.likelihoods import AbsLikelihood, ReluLikelihood
    reset_launches(pl)
    for kind, alpha, cls in (("abs", 1.20, AbsLikelihood),
                             ("relu", 1.34, ReluLikelihood)):
        g = torch.Generator(device="cuda").manual_seed(7)
        t0 = time.perf_counter()
        teacher = tt.glm_generative(
            N=N, alpha=alpha, ensemble_type="gaussian",
            prior_type="gauss_bernoulli", output_type=kind, generator=g,
            device="cuda", dtype=torch.float64, prior_rho=0.4,
            prior_mean=0.0)
        sample = teacher.sample(g)
        student = teacher.to_observed({"y": sample["y"]})
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
        check(type(student.factors[-1]) is cls,
              f"{kind} GLM: the likelihood is "
              f"{type(student.factors[-1]).__name__}")
        x0 = sample["x"]
        init = CustomInit(a_init=[("x", "bwd", 1000.0)],
                          b_init=[("x", "bwd", 1000.0 * x0)])
        ep = tt.ExpectationPropagation(student)
        wall = timed_solve(torch, lambda: ep.iterate(initializer=init,
                                                     **SOLVE))
        x = ep.get_variable_data("x")
        check(bool(torch.isfinite(x["r"]).all()), f"{kind} GLM: non-finite r")
        v_ep = float(x["v"])
        mse = float(((x["r"] - x0) ** 2).mean())
        se = tt.StateEvolution(tt.glm_state_evolution(
            alpha=alpha, prior_type="gauss_bernoulli", output_type=kind,
            prior_rho=0.4, prior_mean=0.0)).iterate(
                max_iter=200, initializer=CustomInit(
                    a_init=[("x", "bwd", 1000.0)]))
        v_se = float(se.get_variable_data("x")["v"])
        kernels, device, wall_ms = sweep_window(ep)
        print(f"{kind} GLM N={N} alpha={alpha} rho=0.4 float64 through "
              f"glm_generative ({cls.__name__}), EP from a0=1000: "
              f"n_iter={ep.n_iter} mse={mse:.6g} v_EP={v_ep:.6g} "
              f"v_SE={v_se:.6g} (SE n_iter={se.n_iter}) wall={wall:.3f} s "
              f"sweeps/s={ep.n_iter / wall:.1f} (model and sample "
              f"{build:.2f} s); torch.profiler over 10 warm sweeps: "
              f"{kernels:.1f} kernels per sweep, device {device:.4f} ms of "
              f"{wall_ms:.4f} ms per sweep, busy "
              f"{100 * device / wall_ms:.2f}% [{card}]")
    launches = read_launches(pl)
    check(not any(launches.values()), f"the GLMs ran kernels: {launches}")
    return launches


def phase_10e_card_against_cpu(torch, tt, pl):
    """The perceptron at N = 256 in float64 through EPSolver on the card
    and on the CPU (the CPU's SVD carried to the card): equal n_iter, r and
    v to rtol 1e-8; and two card solves with the same bits. Returns the
    launches of the card's solves."""
    from tramp_tpu_torch.parallel import EPSolver
    kw = dict(damping=0.1, max_iter=500, tol=1e-6)
    cpu_student, _, cpu_linear = perceptron_student(
        torch, tt, torch.float64, N=256, device="cpu")
    svd = (cpu_linear.U, cpu_linear.s, cpu_linear.V.T)
    gpu_student, _, _ = perceptron_student(torch, tt, torch.float64, N=256,
                                           svd=svd)
    cpu_post, cpu_n, _ = EPSolver(cpu_student, **kw).solve_info(cpu_student)
    reset_launches(pl)
    solver = EPSolver(gpu_student, **kw)
    posts = [solver.solve_info(gpu_student) for _ in range(2)]
    launches = read_launches(pl)
    (post, n_iter, _), (again, n_again, _) = posts
    card_against_cpu(torch, "perceptron N=256 f64 through EPSolver",
                     cpu_post, cpu_n, post, n_iter, ("x",))
    check(all(torch.equal(post["x"][k], again["x"][k]) for k in ("r", "v"))
          and int(n_iter) == int(n_again),
          "perceptron N=256: two solves on the card differ")
    print("perceptron N=256 f64 through EPSolver: two card solves "
          "bit-identical")
    check(not any(launches.values()), f"the perceptron ran kernels: "
                                      f"{launches}")
    return launches


def phase_10(torch, tt, pl, card):
    """Phase 10: the state evolution and EP of the new priors and
    likelihoods. Returns the launches by path (all zero: no new factor
    reaches the kernels)."""
    t0 = time.perf_counter()
    paths, seconds = {}, {}
    paths["se_item3_goldens"], v_se, golden_s = phase_10a_goldens(
        torch, tt, pl, card)
    seconds["a"] = time.perf_counter() - t0
    paths["se_item3_critical_lines"], line_s = phase_10b_critical_lines(
        torch, tt, pl, card)
    seconds["b"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["perceptron_ep"] = phase_10c_perceptron(torch, tt, pl, v_se, card)
    seconds["c"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["glm_abs_relu_ep"] = phase_10d_sign_retrieval_and_relu(
        torch, tt, pl, card)
    seconds["d"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["perceptron_card_vs_cpu"] = phase_10e_card_against_cpu(
        torch, tt, pl)
    seconds["e"] = time.perf_counter() - t0 - sum(seconds.values())
    print(f"phase 10: {time.perf_counter() - t0:.1f} s, by part "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + "; goldens by family " + ", ".join(
              f"{k} {v:.2f} s" for k, v in golden_s.items())
          + "; critical lines by family " + ", ".join(
              f"{k} {v:.2f} s" for k, v in line_s.items()) + f" [{card}]")
    return paths


# -- phase 11: the complex channels and the trees (Queue 1 items 4a, 4b) ----
# BASELINE config 2's second half (bench.py:573-618) and its bounds
# (bench.py:120-128)
PR = dict(N=500, alpha=2.0, rho=0.5, mean=0.01, seed=5)
PR_SOLVE = dict(damping=0.3, max_iter=500, tol=1e-12, wait_increase=20,
                stop_kind="v")
PR_V_F32 = 1e-9
PR_MSE_REL = 5e-2
PR_N_ITER_RATIO = 2.0
PR_EP_N = 2000        # the EP side of phase 11c
#: lanes of the phase-11 batches (cut to 256 if phase 11 passes 150 s)
LANES_11 = 512
# the soft committee of tests/test_models_misc.py:22-34 at N = 2000
COMMITTEE = dict(K=2, alpha=1.5, ensemble_type="gaussian",
                 prior_mean=[0.1, -0.2], prior_var=[1.0, 1.0],
                 noise_var=1e-2)
COMMITTEE_SOLVE = dict(damping=0.3, max_iter=200, tol=1e-6)
# at alpha 1.5 EP does not converge in 200 sweeps and learns little (the
# JAX package alike); at alpha 8, past the learning transition, it
# converges with the damping raised to 0.5
COMMITTEE_LEARNING = dict(COMMITTEE, alpha=8.0)
COMMITTEE_LEARNING_SOLVE = dict(damping=0.5, max_iter=300, tol=1e-6)
COMMITTEE_LEARNING_MSE = 5e-2
COMMITTEE_N = 2000
MULTI_LAYER_N = 4096  # tests/test_models_misc.py:152-173 at the relu net's N
MODULUS_MID_N = 1000  # two-layer phase retrieval, M = 3 N
# BASELINE config 4's protocol (bench.py:625-684) with the synthetic
# decoder of tests/test_vae_prior.py:20-27
VAE_SOLVE = dict(damping=0.5, max_iter=300, tol=1e-6,
                 rollback_increase=float("inf"))
VAE_NOISE = 0.01


def on_card(torch, model, device="cuda"):
    """A copy of a model built on the CPU, on the card (or of one on the
    card, on ``device="cpu"``): the same arrays (operators, their SVD
    factors, observations), moved, so that a solve on the card and one on
    the CPU start from the same instance."""
    import copy
    model = copy.deepcopy(model)
    for f in model.factors:
        f.to(device)
        if getattr(f, "device", None) is not None:
            f.device = torch.device(device)
    return model


#: the floor of the scale a posterior is held at, card against CPU: a mean
#: that is zero on both sides (a symmetric fixed point) is held in absolute
#: terms on the unit scale of these models' variables; a variance, computed
#: from unit-scale moments by cancellation, in absolute terms below 1e-6 of
#: that scale (rtol 1e-8 x 1e-6 is 1e-14, some 50 float64 roundings of a
#: unit second moment; EP near zero noise ends at v = 1e-11); any other key
#: relative to itself
CARD_FLOOR = {"r": 1.0, "v": 1e-6}


def card_against_cpu(torch, what, cpu_post, cpu_n, gpu_post, gpu_n, ids,
                     rtol=1e-8, keys=("r", "v")):
    """Equal n_iter (unless ``cpu_n`` is None) and, element by element,
    |card - CPU| <= rtol (|CPU| + max(max |CPU|, CARD_FLOOR)) for each
    of ``keys`` of every id's posterior; a value that is not finite on
    either side fails, and so does any error where the bound is 0. Prints
    the worst error over its bound by key and the largest |CPU| by key and
    id."""
    worst, scale = {}, {}
    for key in keys:
        ratios = []
        for id in ids:
            want = torch.as_tensor(cpu_post[id][key]).double()
            got = torch.as_tensor(gpu_post[id][key]).double().cpu()
            check(got.shape == want.shape
                  and bool(torch.isfinite(got).all())
                  and bool(torch.isfinite(want).all()),
                  f"{what}: {key} of {id} is {tuple(got.shape)} on the card, "
                  f"{tuple(want.shape)} on the CPU, or not finite")
            err = (got - want).abs()
            top = float(want.abs().max()) if want.numel() else 0.0
            bound = rtol * (want.abs() + max(top, CARD_FLOOR.get(key, 0.0)))
            ratios.append(torch.where(err == 0, torch.zeros_like(err),
                                      err / bound).max())
            scale[key, id] = top
        worst[key] = float(torch.stack(ratios).max())
    same_n = cpu_n is None or int(gpu_n) == int(cpu_n)
    check(same_n and all(math.isfinite(w) and w <= 1.0
                         for w in worst.values()),
          f"{what}: card n_iter {gpu_n} vs CPU {cpu_n}, err over its bound "
          + ", ".join(f"{k} {w:.3g}" for k, w in worst.items())
          + f" (rtol {rtol:g})")
    print(f"{what}, card vs CPU: "
          + (f"n_iter {int(gpu_n)} both, " if cpu_n is not None else "")
          + "worst err over rtol x scale "
          + ", ".join(f"{k} {w:.3e}" for k, w in worst.items())
          + f" (rtol {rtol:g}, bound 1) for {', '.join(ids)}; largest on the "
          "CPU " + ", ".join(f"|{k}| of {id} {top:.4g}"
                             for (k, id), top in scale.items())
          + " (floors " + ", ".join(f"{k} {CARD_FLOOR.get(k, 0.0):g}"
                                    for k in keys) + ")")


def hold_pl_factors(torch, pl, model, state, what):
    """Every piecewise-linear channel of ``model`` at a solve's final
    ``state``: its forward and backward posteriors read out through the
    channel's own methods (the five-output kernel: the path's readout,
    whose launches are returned), then, launches not counted, all three
    kernels held against their plain versions on these inputs, the
    shapes this path gives them (lanes included). Returns (readout
    launches, {wrapper: max abs error})."""
    from tramp_tpu_torch.algos.message_passing import slot, FWD, BWD
    from tramp_tpu_torch.channels import PiecewiseLinearChannel
    from tramp_tpu_torch.lanes import lane_mean
    nodes = [(i, n) for i, n in enumerate(model.nodes)
             if isinstance(n, PiecewiseLinearChannel)]
    inputs_ = []
    for i, node in nodes:
        fwd = state[slot(model.in_edges[i][0], FWD)]
        bwd = state[slot(model.out_edges[i][0], BWD)]
        inputs_.append((fwd["a"], fwd["b"], bwd["a"], bwd["b"]))
    torch.cuda.synchronize()
    reset_launches(pl)
    readouts = [(node.compute_forward_posterior(*args),
                 node.compute_backward_posterior(*args))
                for (_, node), args in zip(nodes, inputs_)]
    torch.cuda.synchronize()
    launches = read_launches(pl)
    check(launches["pl_posterior"] == 2 * len(nodes)
          and not launches["pl_forward_message"]
          and not launches["pl_backward_message"],
          f"{what}: readout launches {launches} for {len(nodes)} channels")
    # a posterior stream can be zero by symmetry (the mean of x under
    # |x|): its floor is rtol on the unit scale of these models' variables
    err = dict.fromkeys(SOURCES, 0.0)
    for (_, node), args, ((rx, vx), (rz, vz)) in zip(nodes, inputs_,
                                                     readouts):
        specs, rtol = node.region_specs, RTOL[dtype_name(rx.dtype)]
        want = pl.pl_posterior_plain(*args, specs)
        az, ax = args[0], args[2]
        _, e = hold(torch, f"{what}: {node.name} posteriors",
                    ("rz", "vz", "rx", "vx"), (rz, vz, rx, vx),
                    (want[0], lane_mean(want[1], az, ax), want[2],
                     lane_mean(want[3], az, ax)), rtol, floor=1.0)
        err["pl_posterior"] = max(err["pl_posterior"], e)
        # a_new = 1/v - a and b_new = r (a + a_new) - b cancel near a fixed
        # point: each element is held at the magnitudes of the two terms
        # its subtraction takes, |a| + |a + a_new| and |b| + |b + b_new|
        for name, fused, plain, (a, b) in (
                ("pl_forward_message", node.compute_forward_message,
                 pl.pl_forward_message_plain, args[2:]),
                ("pl_backward_message", node.compute_backward_message,
                 pl.pl_backward_message_plain, args[:2])):
            got, want = fused(*args), plain(*args, specs)
            line = f"{what}: {node.name} {name}"
            for stream, g, w, term in (("a_new", got[0], want[0], a),
                                       ("b_new", got[1], want[1], b)):
                ratio, e = hold_message(torch, f"{line} {stream}", g, w,
                                        term, rtol)
                err[name] = max(err[name], e)
                line += (f"; {stream} err over rtol x (|{stream[0]}| + "
                         f"|{stream[0]} + {stream}|) {ratio:.3e}, max abs "
                         f"err {e:.3e}, max |{stream[0]}| "
                         f"{float(term.abs().max()):.4g}, |{stream}| median "
                         f"{float(w.abs().median()):.4g} max "
                         f"{float(w.abs().max()):.4g}")
            print(line + f" (rtol {rtol:g})")
    print(f"{what}: {len(nodes)} piecewise-linear channels at the final "
          f"state ({', '.join(n.name for _, n in nodes)}, messages of "
          f"{', '.join(str(tuple(a[1].shape)) for a in inputs_)}): "
          f"posteriors read out in {launches['pl_posterior']} launches; "
          "all three kernels against their plain versions, max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
    return launches, err


def hold_message(torch, what, got, want, term, rtol):
    """One stream of a message kernel (a_new or b_new) against its plain
    version, each element within rtol (|term| + |term + want|), the two
    terms of the subtraction that gives it (``term`` is the side's a or
    b); an error where that bound is 0 fails. Returns (worst error over
    its bound, largest absolute error)."""
    check(got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(got).all()),
          f"{what}: {tuple(got.shape)} {got.dtype} against the plain "
          f"{tuple(want.shape)} {want.dtype}, or not finite")
    err = (got - want).abs()
    bound = rtol * (term.abs() + (term + want).abs())
    ratio = float(torch.where(err == 0, torch.zeros_like(err),
                              err / bound).max())
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{what}: off its plain version by {ratio:.3g} x rtol {rtol:g} "
          "of the terms it subtracts")
    return ratio, float(err.max())


def solve_state(solver, model, initializer=None):
    """An EPSolver's solve with its final state: (post, n_iter, conv,
    state)."""
    post, state, n_iter, conv = solver._run(model,
                                            solver.init_state(initializer))
    return post, n_iter, conv, state


def top_ops(window, names=("i0e", "i1e")):
    """The device time per iteration of the operations whose names hold one
    of ``names``, from a loop_window, and its share."""
    ms = sum(t for op, (c, t) in window["ops"].items()
             if any(n in op.lower() for n in names))
    return ms, ms / window["device_ms"]


def pr_student(torch, tt, dtype, N=PR["N"], device="cuda"):
    """Phase retrieval of bench.py:573-618: complex Gaussian F (numpy
    RandomState), Gauss-Bernoulli x packed (2, N), y = |F x|. Returns
    (student, teacher x as numpy)."""
    from tramp_tpu_torch.channels import ComplexLinearChannel
    from tramp_tpu_torch.likelihoods import ModulusLikelihood
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    M = int(PR["alpha"] * N)
    rng = np.random.RandomState(PR["seed"])
    F = (rng.randn(M, N) + 1j * rng.randn(M, N)) / np.sqrt(2 * N)
    mask = rng.rand(N) < PR["rho"]
    x0 = mask[None, :] * (PR["mean"] + rng.randn(2, N) * np.sqrt(0.5))
    y = np.abs(F @ (x0[0] + 1j * x0[1]))
    kw = dict(device=device, dtype=dtype)
    student = (
        GaussBernoulliPrior(size=(2, N), rho=PR["rho"], mean=PR["mean"], **kw)
        @ tt.V(id="x") @ ComplexLinearChannel(F, name="F", **kw)
        @ tt.V(id="z") @ ModulusLikelihood(y=y, **kw)).to_model()
    return student, x0


def pr_batch(torch, W, lanes, seed):
    """One teacher and observation per lane, drawn on the card: x packed
    (lanes, 2, N) Gauss-Bernoulli(rho, mean), y = |F x|."""
    g = torch.Generator(device=W.device).manual_seed(seed)
    real = W.real.dtype
    kw = dict(generator=g, device=W.device, dtype=real)
    N = W.shape[1]
    mask = torch.rand((lanes, 1, N), **kw) < PR["rho"]
    x = mask * (PR["mean"] + torch.randn((lanes, 2, N), **kw) * 0.5 ** 0.5)
    return x, torch.abs(torch.complex(x[:, 0], x[:, 1]) @ W.T)


def phase_11a_phase_retrieval(torch, tt, pl, card):
    """BASELINE config 2's second half through EPSolver in float32 and
    float64, with bench.py's bounds; a profiled loop window; the same
    instance at N = 128 on the card against the CPU. Returns the launches
    of the path and the float32 student."""
    from tramp_tpu_torch.algos.metrics import phase_symmetric_mse
    from tramp_tpu_torch.parallel import EPSolver
    reset_launches(pl)
    res, students = {}, {}
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        student, x0 = students[dname] = pr_student(torch, tt, dtype)
        solver = EPSolver(student, **PR_SOLVE)
        solver.solve(student)                               # warm-up
        out = {}
        wall = timed_solve(torch, lambda: out.update(
            res=solver.solve_info(student)))
        post, n_iter, conv = out["res"]
        r = post["x"]["r"].double().cpu()
        check(bool(torch.isfinite(r).all()) and r.shape == x0.shape,
              f"phase retrieval {dname}: r not finite or of shape "
              f"{tuple(r.shape)}")
        mse = phase_symmetric_mse(torch.as_tensor(x0), r)
        res[dname] = (mse, float(post["x"]["v"]), int(n_iter), bool(conv))
        print(f"phase retrieval N={PR['N']} alpha=2 {dname} through EPSolver "
              f"(damping 0.3, stop on v, tol 1e-12): n_iter={int(n_iter)} "
              f"conv={bool(conv)} phase-symmetric mse={mse:.6g} "
              f"v={res[dname][1]:.6g} wall={wall:.3f} s "
              f"iterations/s={int(n_iter) / wall:.1f} [{card}]")
    launches = read_launches(pl)
    (mse32, v32, n32, c32), (mse64, v64, n64, c64) = (res["float32"],
                                                      res["float64"])
    mse_rel = abs(mse32 - mse64) / mse64
    check(c32 and c64 and v32 <= PR_V_F32 and mse_rel < PR_MSE_REL
          and n32 <= PR_N_ITER_RATIO * n64,
          f"phase retrieval: conv {c32}/{c64}, v f32 {v32:.3g} (bound "
          f"{PR_V_F32}), mse f32 vs f64 {mse_rel:.3g} (bound {PR_MSE_REL}), "
          f"n_iter {n32} vs {n64} (ratio bound {PR_N_ITER_RATIO})")
    print(f"phase retrieval, bench.py:120-128 bounds: converged in both "
          f"dtypes, v f32 {v32:.3e} <= {PR_V_F32}, mse f32 vs f64 rel err "
          f"{mse_rel:.3e} < {PR_MSE_REL}, n_iter f32/f64 {n32}/{n64} <= "
          f"{PR_N_ITER_RATIO}x")
    check(not any(launches.values()),
          f"phase retrieval ran kernels: {launches}")
    student = students["float32"][0]
    print_window("phase retrieval float32, one instance, EPSolver",
                 loop_window(lambda k: EPSolver(
                     student, **dict(PR_SOLVE, max_iter=k, tol=0.0,
                                     rollback_increase=float("inf"))).solve(
                         student)), card)
    # the same instance at N = 128 on the CPU and on the card
    cpu, _ = pr_student(torch, tt, torch.float64, N=128, device="cpu")
    gpu = on_card(torch, cpu)
    cpu_post, cpu_n, _ = EPSolver(cpu, **PR_SOLVE).solve_info(cpu)
    gpu_post, gpu_n, _ = EPSolver(gpu, **PR_SOLVE).solve_info(gpu)
    card_against_cpu(torch, "phase retrieval N=128 f64 through EPSolver",
                     cpu_post, cpu_n, gpu_post, gpu_n, ("x", "z"))
    return launches, student


def phase_11b_phase_retrieval_batch(torch, tt, pl, student, lanes, card):
    """LANES_11 lanes of phase retrieval on one F, float32, a teacher and y
    per lane; three lanes against their single solves; readings with the
    modulus likelihood's share of the device time. Returns the launches."""
    from tramp_tpu_torch.algos.metrics import phase_symmetric_mse
    from tramp_tpu_torch.parallel import EPSolver, with_buffers
    W = student.factors[1].W
    xs, ys = pr_batch(torch, W, lanes, seed=8)
    stacked = with_buffers(student, {(2, "y"): ys})
    solver = EPSolver(student, **PR_SOLVE)
    what = f"phase retrieval float32, EPSolver.solve_batch over {lanes} lanes"
    w = print_window(what, loop_window(lambda k: EPSolver(
        student, **dict(PR_SOLVE, max_iter=k, tol=0.0,
                        rollback_increase=float("inf"))).solve_batch(
                            stacked)), card)
    ms, share = top_ops(w)
    print(f"{what}: the modulus likelihood's Bessel kernels (i0e, i1e) "
          f"{ms:.4f} ms per iteration, {100 * share:.2f}% of the device time")
    post, n_iter, conv, launches = batched_solve(
        torch, pl, what, lambda: _ep_batch(solver, stacked), lanes, card, w)
    mses = [phase_symmetric_mse(xs[i].double().cpu(),
                                post["x"]["r"][i].double().cpu())
            for i in (0, lanes // 2, lanes - 1)]
    print(f"{what}: {int(conv.sum())} of {lanes} lanes converged; "
          f"phase-symmetric mse of lanes 0, {lanes // 2}, {lanes - 1}: "
          + ", ".join(f"{m:.4g}" for m in mses))
    lanes_against_singles(torch, what, solver, student, 2, ys, post, n_iter)
    check(not any(launches.values()), f"{what}: ran kernels {launches}")
    return launches


def phase_11c_ep_against_se(torch, tt, pl, card):
    """EP on glm_generative(output_type="modulus") at N = PR_EP_N in
    float64 at the PR_EP_VS_SE_ROWS alphas, against the pinned SE values
    (which phase 10a holds on the card): |v_EP - v_SE| / v_SE < 0.25. Then
    the modulus channel inside a graph (two-layer phase retrieval of
    tests/test_modulus_channel.py:125-157 at N = MODULUS_MID_N): a solve, a
    profiled sweep window and the channel's share of it. Returns the
    launches."""
    from tramp_tpu_torch.channels import (
        ComplexLinearChannel, GaussianChannel, ModulusChannel)
    from tramp_tpu_torch.parallel import EPSolver
    from tramp_tpu_torch.priors import GaussianPrior
    reset_launches(pl)
    for alpha, v_se in PR_EP_VS_SE_ROWS:
        g = torch.Generator(device="cuda").manual_seed(13)
        teacher = tt.glm_generative(
            N=PR_EP_N, alpha=alpha, ensemble_type="complex_gaussian",
            prior_type="gauss_bernoulli", output_type="modulus",
            generator=g, device="cuda", dtype=torch.float64, prior_rho=0.5,
            prior_mean=0.01)
        student = teacher.to_observed({"y": teacher.sample(g)["y"]})
        out = {}
        wall = timed_solve(torch, lambda: out.update(res=EPSolver(
            student, damping=0.3, max_iter=200, tol=1e-6,
            wait_increase=10).solve_info(student)))
        post, n_iter, conv = out["res"]
        check(bool(torch.isfinite(post["x"]["r"]).all()),
              f"PR EP alpha={alpha}: r not finite")
        v_ep = float(post["x"]["v"])
        gap = abs(v_ep - v_se) / v_se
        check(gap < EP_SE_BAND, f"PR EP vs SE alpha={alpha}: |v_EP - v_SE| "
                                f"/ v_SE = {gap:.3g} (band {EP_SE_BAND})")
        print(f"EP against SE, phase retrieval N={PR_EP_N} alpha={alpha} "
              f"float64 through glm_generative: v_SE={v_se:.6g} "
              f"v_EP={v_ep:.6g} |v_EP-v_SE|/v_SE={gap:.3e} (band "
              f"{EP_SE_BAND}), n_iter={int(n_iter)} conv={bool(conv)} "
              f"wall={wall:.3f} s [{card}]")
    # the modulus channel inside a graph: its radial quadrature on the card
    N, M = MODULUS_MID_N, 3 * MODULUS_MID_N
    g = torch.Generator(device="cuda").manual_seed(2)
    kw = dict(device="cuda", dtype=torch.float64)
    W = torch.complex(torch.randn((M, N), generator=g, **kw),
                      torch.randn((M, N), generator=g, **kw)) / (2 * N) ** 0.5
    modulus = ModulusChannel()
    teacher = (GaussianPrior(size=(2, N), mean=0.3, **kw) @ tt.V(id="x")
               @ ComplexLinearChannel(W, name="W") @ tt.V(id="z")
               @ modulus @ tt.V(id="a") @ GaussianChannel(var=1e-4)
               @ tt.O(id="y")).to_model()
    sample = teacher.sample(g)
    student = teacher.to_observed({"y": sample["y"]})
    ep = tt.ExpectationPropagation(student)
    wall = timed_solve(torch, lambda: ep.iterate(max_iter=200, damping=0.3))
    from tramp_tpu_torch.algos.metrics import phase_symmetric_mse
    mse = phase_symmetric_mse(sample["x"].cpu(),
                              ep.get_variable_data("x")["r"].cpu())
    tau = float((sample["x"] ** 2).mean())
    check(np.isfinite(mse) and mse < 0.5 * tau,
          f"two-layer phase retrieval: phase-symmetric mse {mse:.3g}, "
          f"signal power {tau:.3g}")
    n = ep.n_iter
    kernels, device, wall_ms = sweep_window(ep)
    from tramp_tpu_torch.algos.message_passing import slot, FWD, BWD
    i = next(i for i, n in enumerate(ep.nodes) if n is modulus)
    args = (ep.state[slot(ep.model.in_edges[i][0], FWD)]["a"],
            ep.state[slot(ep.model.in_edges[i][0], FWD)]["b"],
            ep.state[slot(ep.model.out_edges[i][0], BWD)]["a"],
            ep.state[slot(ep.model.out_edges[i][0], BWD)]["b"])
    _, quad_ms, _ = profiled(
        lambda: (modulus.compute_forward_message(*args),
                 modulus.compute_backward_message(*args)), 5)
    print(f"two-layer phase retrieval N={N} M={M} float64 (modulus channel "
          f"mid-graph, radial quadrature of 128 nodes per element): "
          f"n_iter={n} phase-symmetric mse={mse:.4g} (signal power "
          f"{tau:.4g}) wall={wall:.3f} s; torch.profiler over 10 warm "
          f"sweeps: {kernels:.1f} kernels per sweep, device {device:.4f} ms "
          f"of {wall_ms:.4f} ms per sweep; the modulus channel's two "
          f"messages {quad_ms:.4f} ms of device time, "
          f"{100 * quad_ms / device:.1f}% of the sweep's [{card}]")
    launches = read_launches(pl)
    check(not any(launches.values()), f"phase retrieval EP ran kernels: "
                                      f"{launches}")
    return launches


def committee_student(torch, tt, N, dtype, device, seed, config=COMMITTEE):
    """The soft committee (``config``) at N: (student, teacher sample,
    teacher, generator)."""
    g = torch.Generator(device=device).manual_seed(seed)
    teacher = tt.models.soft_committee(N=N, generator=g, device=device,
                                       dtype=dtype, **config)
    sample = teacher.sample(g)
    return teacher.to_observed({"y": sample["y"]}), sample, teacher, g


def phase_11d_committee(torch, tt, pl, lanes, card):
    """The soft committee through dispatch_solver (an EPSolver) at
    N = COMMITTEE_N in float32: the relu kernels once forward and once
    backward per expert per sweep; its piecewise-linear factors read out
    and held against the plain versions; N = 256 float64 on the card
    against the CPU; then ``lanes`` lanes, one y per lane; then the same
    past the learning transition (committee_learning). Returns (launches
    of the path, max abs errors, the N = 256 float64 CPU student for phase
    11g)."""
    from tramp_tpu_torch.parallel import (
        EPSolver, dispatch_solver, with_buffers)
    K = COMMITTEE["K"]
    student, sample, teacher, g = committee_student(
        torch, tt, COMMITTEE_N, torch.float32, "cuda", 3)
    solver = dispatch_solver(student, **COMMITTEE_SOLVE)
    check(type(solver) is EPSolver,
          f"committee: dispatch_solver gave {type(solver).__name__}")
    solver.solve(student)                                   # warm-up
    torch.cuda.synchronize()
    reset_launches(pl)
    out = {}
    wall = timed_solve(torch, lambda: out.update(
        res=solve_state(solver, student)))
    launches = read_launches(pl)
    post, n_iter, conv, state = out["res"]
    n = int(n_iter)
    check(launches["pl_forward_message"] == launches["pl_backward_message"]
          == K * n > 0 and launches["pl_posterior"] == 0,
          f"committee: launches {launches} for {n} sweeps of {K} experts")
    for k in range(K):
        d = post[f"x_{k}"]
        v = float(d["v"])
        check(bool(torch.isfinite(d["r"]).all()) and 0 < v < 1.5,
              f"committee x_{k}: v={v:.4g} or r not finite")
    mses = [float(((post[f"x_{k}"]["r"] - sample[f"x_{k}"]) ** 2).mean())
            for k in range(K)]
    print(f"soft committee K={K} N={COMMITTEE_N} alpha=1.5 float32 through "
          f"dispatch_solver (EPSolver): n_iter={n} conv={bool(conv)} "
          f"v={[round(float(post[f'x_{k}']['v']), 6) for k in range(K)]} "
          f"mse={[round(m, 6) for m in mses]} wall={wall:.3f} s "
          f"sweeps/s={n / wall:.1f}; launches {launches}: "
          f"{launches['pl_forward_message'] / n:g} forward and "
          f"{launches['pl_backward_message'] / n:g} backward relu messages "
          f"per sweep ({K} experts) [{card}]")
    readout, err = hold_pl_factors(torch, pl, student, state,
                                   "committee float32")
    print_window("soft committee float32, one instance, EPSolver",
                 loop_window(lambda k: EPSolver(
                     student, damping=0.3, max_iter=k, tol=0.0,
                     rollback_increase=float("inf")).solve(student)), card)
    # N = 256 float64, card against CPU
    cpu = committee_student(torch, tt, 256, torch.float64, "cpu", 4)[0]
    gpu = on_card(torch, cpu)
    cpu_post, cpu_n, _ = EPSolver(cpu, **COMMITTEE_SOLVE).solve_info(cpu)
    gpu_post, gpu_n, _ = EPSolver(gpu, **COMMITTEE_SOLVE).solve_info(gpu)
    card_against_cpu(torch, "soft committee N=256 f64 through EPSolver",
                     cpu_post, cpu_n, gpu_post, gpu_n, ("x_0", "x_1", "a_0"))
    # lanes: the teacher's F, a teacher x and y per lane
    ys = torch.stack([teacher.sample(g)["y"] for _ in range(lanes)])
    likelihood = len(student.factors) - 1
    stacked = with_buffers(student, {(likelihood, "y"): ys})
    what = f"soft committee float32, EPSolver.solve_batch over {lanes} lanes"
    w = print_window(what, loop_window(lambda k: EPSolver(
        student, damping=0.3, max_iter=k, tol=0.0,
        rollback_increase=float("inf")).solve_batch(stacked)), card)
    post, n_iter, conv, batch = batched_solve(
        torch, pl, what, lambda: _ep_batch(solver, stacked), lanes, card, w)
    check(batch["pl_forward_message"] == batch["pl_backward_message"]
          == K * int(n_iter.max()),
          f"{what}: launches {batch} for {int(n_iter.max())} iterations")
    lanes_against_singles(torch, what, solver, student, likelihood, ys,
                          post, n_iter, ids=[f"x_{k}" for k in range(K)])
    learning = committee_learning(torch, tt, pl, lanes, card)
    total = {k: launches[k] + readout[k] + batch[k] + learning[k]
             for k in launches}
    return total, err, cpu


def committee_learning(torch, tt, pl, lanes, card):
    """The soft committee past its learning transition (COMMITTEE_LEARNING,
    N = COMMITTEE_N, float32) through dispatch_solver: each expert's MSE
    under COMMITTEE_LEARNING_MSE, the relu kernels once forward and once
    backward per expert per sweep; then ``lanes`` lanes, one y per lane,
    as readings of a solve that converges. Returns the launches."""
    from tramp_tpu_torch.parallel import (
        EPSolver, dispatch_solver, with_buffers)
    K = COMMITTEE["K"]
    student, sample, teacher, g = committee_student(
        torch, tt, COMMITTEE_N, torch.float32, "cuda", 3, COMMITTEE_LEARNING)
    solver = dispatch_solver(student, **COMMITTEE_LEARNING_SOLVE)
    EPSolver(student, **dict(COMMITTEE_LEARNING_SOLVE,
                             max_iter=3)).solve(student)       # warm-up
    reset_launches(pl)
    out = {}
    wall = timed_solve(torch, lambda: out.update(
        res=solver.solve_info(student)))
    launches = read_launches(pl)
    post, n_iter, conv = out["res"]
    n = int(n_iter)
    v = [float(post[f"x_{k}"]["v"]) for k in range(K)]
    mses = [float(((post[f"x_{k}"]["r"] - sample[f"x_{k}"]) ** 2).mean())
            for k in range(K)]
    what = (f"soft committee K={K} N={COMMITTEE_N} alpha="
            f"{COMMITTEE_LEARNING['alpha']:g} float32")
    check(all(bool(torch.isfinite(post[f"x_{k}"]["r"]).all())
              for k in range(K)) and max(mses) < COMMITTEE_LEARNING_MSE
          and launches["pl_forward_message"]
          == launches["pl_backward_message"] == K * n > 0,
          f"{what}: mse {mses} (bound {COMMITTEE_LEARNING_MSE}), launches "
          f"{launches} for {n} sweeps")
    print(f"{what} through dispatch_solver ({type(solver).__name__}): "
          f"n_iter={n} conv={bool(conv)} v={[round(x, 6) for x in v]} "
          f"mse={[round(m, 6) for m in mses]} (bound "
          f"{COMMITTEE_LEARNING_MSE}) wall={wall:.3f} s sweeps/s="
          f"{n / wall:.1f}; launches {launches} [{card}]")
    ys = torch.stack([teacher.sample(g)["y"] for _ in range(lanes)])
    likelihood = len(student.factors) - 1
    stacked = with_buffers(student, {(likelihood, "y"): ys})
    what += f", EPSolver.solve_batch over {lanes} lanes"
    w = print_window(what, loop_window(lambda k: EPSolver(
        student, **dict(COMMITTEE_LEARNING_SOLVE, max_iter=k, tol=0.0,
                        rollback_increase=float("inf"))).solve_batch(
            stacked)), card)
    _, n_iter, _, batch = batched_solve(
        torch, pl, what, lambda: _ep_batch(solver, stacked), lanes, card, w,
        warm_up=False)
    check(batch["pl_forward_message"] == batch["pl_backward_message"]
          == K * int(n_iter.max()),
          f"{what}: launches {batch} for {int(n_iter.max())} iterations")
    return {k: launches[k] + batch[k] for k in launches}


def phase_11e_multi_layer(torch, tt, pl, card):
    """MultiLayerModel([GaussBernoulliPrior(rho=0.5), AbsChannel(),
    GaussianChannel(var=1e-2)]) at N = MULTI_LAYER_N in float32 through the
    engine (tests/test_models_misc.py:152-173): MSE of t_1 under 5e-2, one
    abs message of each side per sweep. Returns (launches, max abs
    errors)."""
    from tramp_tpu_torch.channels import AbsChannel, GaussianChannel
    from tramp_tpu_torch.models import MultiLayerModel
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    N = MULTI_LAYER_N
    model = MultiLayerModel(
        [GaussBernoulliPrior(size=N, rho=0.5, device="cuda",
                             dtype=torch.float32),
         AbsChannel(), GaussianChannel(var=1e-2)])
    check(model.ids == ["x", "t_1", "y"], f"multi-layer ids {model.ids}")
    sample = model.sample(torch.Generator(device="cuda").manual_seed(0))
    student = model.to_observed({"y": sample["y"]})
    ep = tt.ExpectationPropagation(student)
    ep.iterate(max_iter=100, damping=0.3)                  # warm-up
    torch.cuda.synchronize()
    reset_launches(pl)
    wall = timed_solve(torch, lambda: ep.iterate(max_iter=100, damping=0.3))
    launches = read_launches(pl)
    n = ep.n_iter
    check(launches["pl_forward_message"] == launches["pl_backward_message"]
          == n > 0 and launches["pl_posterior"] == 0,
          f"multi-layer: launches {launches} for {n} sweeps")
    r_t = ep.get_variable_data("t_1")["r"]
    mse_t = float(((r_t - sample["t_1"]) ** 2).mean())
    check(mse_t < 5e-2, f"multi-layer: mse of t_1 {mse_t:.3g} (bound 5e-2)")
    kernels, device, wall_ms = sweep_window(ep)
    print(f"multi-layer model x -> abs -> + noise -> y, N={N} float32 "
          f"through the engine: n_iter={n} mse(t_1)={mse_t:.6g} "
          f"(bound 5e-2) wall={wall:.3f} s sweeps/s={n / wall:.1f}, "
          f"launches {launches}; torch.profiler over 10 warm sweeps: "
          f"{kernels:.1f} kernels per sweep, device {device:.4f} ms of "
          f"{wall_ms:.4f} ms per sweep, busy {100 * device / wall_ms:.2f}% "
          f"[{card}]")
    readout, err = hold_pl_factors(torch, pl, student, ep.state,
                                   "multi-layer float32")
    return {k: launches[k] + readout[k] for k in launches}, err


def vae_student(torch, tt, dtype, device):
    """BASELINE config 4 (bench.py:625-684) with the synthetic decoder of
    tests/test_vae_prior.py:20-27: the teacher computed in numpy float64
    (RandomState(7)), the 25% middle band erased, observed through an
    identity-row operator with noise 0.01. Returns (student, x0, band)."""
    from tramp_tpu_torch.channels import LinearChannel
    from tramp_tpu_torch.likelihoods import GaussianLikelihood
    from tramp_tpu_torch.models import vae_prior_block
    rng = np.random.RandomState(0)
    weights = [rng.randn(400, 20) / np.sqrt(20),
               rng.randn(784, 400) / np.sqrt(400)]
    biases = [rng.randn(400) * 0.01, rng.randn(784) * 0.01]
    W1, W2 = weights
    b1, b2 = biases
    rng = np.random.RandomState(7)
    z0 = rng.randn(20)
    x0 = np.clip(W2 @ np.maximum(W1 @ z0 + b1, 0.0) + b2, -1.0, 1.0)
    y_full = x0 + np.sqrt(VAE_NOISE) * rng.randn(784)
    band = np.zeros(784, bool)
    n_rem = int(0.25 * 784)
    band[392 - n_rem // 2: 392 - n_rem // 2 + n_rem] = True
    kw = dict(device=device, dtype=dtype)
    student = (vae_prior_block(weights, biases, **kw) @ tt.V(id="x")
               @ LinearChannel(np.eye(784)[~band], name="F", **kw)
               @ tt.V(id="z")
               @ GaussianLikelihood(y=y_full[~band], var=VAE_NOISE, **kw)
               ).to_model()
    return student, x0, band


def phase_11f_vae(torch, tt, pl, card):
    """The VAE prior's inpainting through EPSolver from NoisyInit(seed=3),
    float32 and float64, 300 sweeps: the band MSE beside the fill-zero
    MSE, 2 forward and 2 backward piecewise-linear messages per sweep;
    then a 30-sweep float64 snapshot on the card against the CPU (EP on
    this model has no fixed point). Returns (launches, max abs errors)."""
    from tramp_tpu_torch.algos import NoisyInit
    from tramp_tpu_torch.parallel import EPSolver
    total, err = None, None
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        student, x0, band = vae_student(torch, tt, dtype, "cuda")
        solver = EPSolver(student, **VAE_SOLVE)
        solver.solve(student, initializer=NoisyInit(seed=3))   # warm-up
        torch.cuda.synchronize()
        reset_launches(pl)
        out = {}
        wall = timed_solve(torch, lambda: out.update(res=solve_state(
            solver, student, NoisyInit(seed=3))))
        launches = read_launches(pl)
        post, n_iter, conv, state = out["res"]
        n = int(n_iter)
        check(launches["pl_forward_message"] == launches["pl_backward_message"]
              == 2 * n > 0 and launches["pl_posterior"] == 0,
              f"VAE {dname}: launches {launches} for {n} sweeps")
        r = post["x"]["r"].double().cpu().numpy()
        check(np.isfinite(r).all(), f"VAE {dname}: r not finite")
        mse_band = min(float(np.mean((r[band] - x0[band]) ** 2)),
                       float(np.mean((r[band] + x0[band]) ** 2)))
        mse_trivial = float(np.mean(x0[band] ** 2))
        print(f"VAE prior inpainting (synthetic 20-400-784 decoder, 25% "
              f"band erased) {dname} through EPSolver from NoisyInit(3): "
              f"n_iter={n} conv={bool(conv)} band mse={mse_band:.6g} beside "
              f"fill-zero {mse_trivial:.6g} (ratio "
              f"{mse_band / mse_trivial:.4f}) wall={wall:.3f} s "
              f"sweeps/s={n / wall:.1f}; launches {launches}: "
              f"{launches['pl_forward_message'] / n:g} forward and "
              f"{launches['pl_backward_message'] / n:g} backward messages "
              f"per sweep [{card}]")
        if total is None:
            readout, err = hold_pl_factors(torch, pl, student, state,
                                           f"VAE prior {dname}")
            total = {k: launches[k] + readout[k] for k in launches}
            print_window(f"VAE prior {dname}, one instance, EPSolver",
                         loop_window(lambda k: EPSolver(
                             student, **dict(VAE_SOLVE, max_iter=k)).solve(
                                 student, initializer=NoisyInit(seed=3))),
                         card)
    cpu, _, _ = vae_student(torch, tt, torch.float64, "cpu")
    gpu = on_card(torch, cpu)
    snap = dict(VAE_SOLVE, max_iter=30)
    cpu_post, cpu_n = EPSolver(cpu, **snap).solve(
        cpu, initializer=NoisyInit(seed=3))
    gpu_post, gpu_n = EPSolver(gpu, **snap).solve(
        gpu, initializer=NoisyInit(seed=3))
    card_against_cpu(torch, "VAE prior, 30-sweep snapshot, f64",
                     cpu_post, cpu_n, gpu_post, gpu_n,
                     ("x", "z_0", "z_1", "z_2"))
    return total, err


def phase_11g_se_of_trees(torch, tt, pl, cpu_committee, card):
    """StateEvolution of the soft committee (the N = 256 float64 student of
    11d, whose linear channels' spectra are the instance's) on the card
    against the CPU: equal n_iter, every variable's v to rtol 1e-10.
    Returns the launches of the card's solve."""
    gpu = on_card(torch, cpu_committee)
    cpu_se = tt.StateEvolution(cpu_committee, device="cpu").iterate(
        max_iter=200)
    reset_launches(pl)
    out = {}
    wall = timed_solve(torch, lambda: out.update(
        se=tt.StateEvolution(gpu).iterate(max_iter=200)))
    launches = read_launches(pl)
    se = out["se"]
    cpu_v = cpu_se.get_variables_data()
    card_against_cpu(torch, "SE of the soft committee N=256 float64",
                     cpu_v, cpu_se.n_iter,
                     {id: se.get_variable_data(id) for id in cpu_v},
                     se.n_iter, tuple(cpu_v), rtol=1e-10, keys=("v",))
    print(f"SE of the soft committee N=256 float64 on the card: wall "
          f"{wall:.3f} s, launches {launches} [{card}]")
    return launches


def phase_11(torch, tt, pl, card):
    """Phase 11: the complex channels and the trees. Returns (launches by
    path, {path: max abs error by kernel at the path's final state})."""
    t0 = time.perf_counter()
    lanes = LANES_11
    paths, seconds, err = {}, {}, {}

    def lap(part):
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    paths["phase_retrieval_ep"], pr = phase_11a_phase_retrieval(
        torch, tt, pl, card)
    lap("a")
    paths["phase_retrieval_batch"] = phase_11b_phase_retrieval_batch(
        torch, tt, pl, pr, lanes, card)
    lap("b")
    paths["phase_retrieval_ep_vs_se"] = phase_11c_ep_against_se(
        torch, tt, pl, card)
    lap("c")
    if time.perf_counter() - t0 > 150 and lanes > 256:
        lanes = 256
        print("phase 11 passed 150 s before 11d: the committee's batch is "
              "cut to 256 lanes")
    paths["committee_ep"], err["committee_ep"], cpu_committee = \
        phase_11d_committee(torch, tt, pl, lanes, card)
    lap("d")
    paths["multi_layer_ep"], err["multi_layer_ep"] = phase_11e_multi_layer(
        torch, tt, pl, card)
    lap("e")
    paths["vae_prior_ep"], err["vae_prior_ep"] = phase_11f_vae(
        torch, tt, pl, card)
    lap("f")
    paths["se_committee"] = phase_11g_se_of_trees(torch, tt, pl,
                                                  cpu_committee, card)
    lap("g")
    for path in ("committee_ep", "multi_layer_ep", "vae_prior_ep"):
        check(all(paths[path][k] > 0 for k in SOURCES),
              f"phase 11 {path}: a kernel never launched: {paths[path]}")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s, by part "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; batches of {lanes} lanes [{card}]")
    return paths, err


# -- phase 12: item 3's factors the card had never run -----------------------
PHASE_12_N = 400


def phase_12(torch, tt, pl, card):
    """One EP solve and one SE solve, float64, of each prior, likelihood and
    analytic channel of ROADMAP Queue 1 item 3 that no earlier phase runs
    on the card, through glm_generative / glm_state_evolution where those
    build it (the MAP priors and the analytic channels have no SE in the
    JAX package; the L21 and committee-binary priors take an (N, K)
    shape, which the GLM builders do not build: the L21 prior is solved as
    a denoiser and in a GLM through a dense LinearChannel; the
    committee-binary prior's K x K precision is not what the EP engine
    passes, so its denoiser is solved in its one exact step); EP on the
    card against the same model on the CPU (equal n_iter, r and v to rtol
    1e-8). Returns the launches."""
    from tramp_tpu_torch.algos import ConstantInit
    from tramp_tpu_torch.channels import (
        AnalyticAbsChannel, AnalyticReluChannel, GaussianChannel,
        LinearChannel)
    from tramp_tpu_torch.likelihoods import GaussianLikelihood
    from tramp_tpu_torch.parallel import EPSolver
    from tramp_tpu_torch.priors import (
        CommitteeBinaryPrior, GaussBernoulliPrior, MAP_L21NormPrior)
    t0 = time.perf_counter()
    reset_launches(pl)
    f64 = torch.float64
    kw = dict(damping=0.1, max_iter=50, tol=1e-6)
    gauss = dict(output_type="gaussian", output_var=1e-2)
    gb = dict(prior_type="gauss_bernoulli", prior_rho=0.5)
    cases = [
        ("prior gaussian", dict(prior_type="gaussian", **gauss), True),
        ("prior exponential", dict(prior_type="exponential", **gauss), True),
        ("prior positive", dict(prior_type="positive", **gauss), True),
        ("prior mixture", dict(prior_type="mixture", **gauss), True),
        ("prior L1_norm", dict(prior_type="L1_norm", **gauss), False),
        ("likelihood l-relu", dict(output_type="l-relu", output_slope=0.1,
                                   **gb), True),
        ("likelihood h-tanh", dict(output_type="h-tanh", **gb), True),
        ("likelihood h-sigm", dict(output_type="h-sigm", **gb), True),
        ("likelihood a-abs", dict(output_type="a-abs", output_shift=1e-3,
                                  **gb), True)]
    for name, build, has_se in cases:
        alpha = 1.5 if name.startswith("likelihood") else 1.0
        models = {}
        for device in ("cpu", "cuda"):
            g = torch.Generator(device="cpu").manual_seed(0)
            teacher = tt.glm_generative(
                N=PHASE_12_N, alpha=alpha, ensemble_type="gaussian",
                generator=g, device="cpu", dtype=f64, **build)
            models[device] = teacher.to_observed(
                {"y": teacher.sample(g)["y"]})
        models["cuda"] = on_card(torch, models["cuda"])
        # the MAP priors' messages are not finite from a = 0 (as in the
        # JAX package): they start from a = 1
        init = None if has_se else ConstantInit(a=1.0, b=0.0)
        res = {d: EPSolver(m, **kw).solve_info(m, initializer=init)
               for d, m in models.items()}
        post, n_iter, conv = res["cuda"]
        check(bool(torch.isfinite(post["x"]["r"]).all())
              and bool(torch.isfinite(post["x"]["v"]).all()),
              f"phase 12 {name}: EP posterior not finite")
        card_against_cpu(torch, f"phase 12 {name}, N={PHASE_12_N} f64 EP",
                         res["cpu"][0], res["cpu"][1], post, n_iter, ("x",))
        line = (f"phase 12 {name}: EP n_iter={int(n_iter)} conv={bool(conv)} "
                f"v={float(post['x']['v']):.6g}")
        if has_se:
            se_build = {k: v for k, v in build.items()}
            se = tt.StateEvolution(tt.glm_state_evolution(
                alpha=alpha, **se_build)).iterate(max_iter=50)
            v_se = float(se.get_variable_data("x")["v"])
            check(np.isfinite(v_se) and v_se > 0,
                  f"phase 12 {name}: SE v {v_se}")
            line += f"; SE n_iter={se.n_iter} v={v_se:.6g}"
        else:
            line += "; no SE (the JAX package defines none for MAP priors)"
        print(line + f" [{card}]")
    # the analytic activations: one EP solve each. Under |z| a prior of
    # mean 0 leaves EP at the symmetric fixed point r = 0 from b = 0: the
    # abs instance's prior has mean 1, and EP converges there
    for cls, mean in ((AnalyticAbsChannel, 1.0), (AnalyticReluChannel, 0.0)):
        models = {}
        rng = np.random.RandomState(1)
        W = rng.randn(600, PHASE_12_N) / np.sqrt(PHASE_12_N)
        for device in ("cpu", "cuda"):
            dkw = dict(device=device, dtype=f64)
            teacher = (GaussBernoulliPrior(size=PHASE_12_N, rho=0.5,
                                           mean=mean, **dkw)
                       @ tt.V(id="x") @ LinearChannel(W, name="W", **dkw)
                       @ tt.V(id="z") @ cls() @ tt.V(id="a")
                       @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
            models[device] = teacher
        y = models["cpu"].sample(torch.Generator().manual_seed(2))["y"]
        models["cuda"] = on_card(torch, models["cpu"].to_observed({"y": y}))
        models["cpu"] = models["cpu"].to_observed({"y": y})
        res = {d: EPSolver(m, **kw).solve_info(m) for d, m in models.items()}
        post, n_iter, conv = res["cuda"]
        check(bool(torch.isfinite(post["x"]["r"]).all())
              and float(post["z"]["r"].abs().max()) > 0,
              f"phase 12 {cls.__name__}: EP posterior not finite, or the "
              "mean of z is 0 everywhere")
        card_against_cpu(torch, f"phase 12 {cls.__name__} EP", res["cpu"][0],
                         res["cpu"][1], post, n_iter, ("x", "z"))
        print(f"phase 12 {cls.__name__} (prior mean {mean:g}): EP "
              f"n_iter={int(n_iter)} conv={bool(conv)} "
              f"v={float(post['x']['v']):.6g}; no SE "
              f"(the JAX package defines none for this channel) [{card}]")
    # priors the GLM builders cannot build (their shape is (N, K)): the
    # L21 prior as a denoiser, and in a GLM, its (N, 2) variable through a
    # dense LinearChannel (which tells lanes from the precision, so that a
    # trailing K axis multiplies as W @ Z)
    rng = np.random.RandomState(3)
    models = {}
    for device in ("cpu", "cuda"):
        dkw = dict(device=device, dtype=f64)
        models[device] = (MAP_L21NormPrior(size=(PHASE_12_N, 2), **dkw)
                          @ tt.V(id="x") @ GaussianChannel(var=1e-1)
                          @ tt.O(id="y")).to_model()
    y = torch.as_tensor(rng.randn(PHASE_12_N, 2), dtype=f64)
    models["cuda"] = on_card(torch, models["cpu"].to_observed({"y": y}))
    models["cpu"] = models["cpu"].to_observed({"y": y})
    # the group threshold needs a direction: b = 1 at the start, as the
    # JAX package needs it
    res = {d: EPSolver(m, **kw).solve_info(
        m, initializer=ConstantInit(a=1.0, b=1.0)) for d, m in models.items()}
    card_against_cpu(torch, "phase 12 prior L21_norm, (N, 2) x denoised, EP",
                     res["cpu"][0], res["cpu"][1], res["cuda"][0],
                     res["cuda"][1], ("x",))
    print(f"phase 12 prior L21_norm: EP n_iter={int(res['cuda'][1])} "
          f"conv={bool(res['cuda'][2])}; no SE (none in the JAX package) "
          f"[{card}]")
    M = 300
    W = rng.randn(M, PHASE_12_N) / np.sqrt(PHASE_12_N)
    x0 = rng.randn(PHASE_12_N, 2) * (rng.rand(PHASE_12_N, 1) < 0.2)
    y = W @ x0 + 0.1 * rng.randn(M, 2)
    cpu = (MAP_L21NormPrior(size=(PHASE_12_N, 2), axis=1, device="cpu",
                            dtype=f64)
           @ tt.V(id="x") @ LinearChannel(W, name="W", device="cpu",
                                          dtype=f64)
           @ tt.V(id="z") @ GaussianLikelihood(y=y, var=1e-2, device="cpu",
                                               dtype=f64)).to_model()
    models = {"cpu": cpu, "cuda": on_card(torch, cpu)}
    res = {d: EPSolver(m, **kw).solve_info(
        m, initializer=ConstantInit(a=1.0, b=1.0)) for d, m in models.items()}
    post = res["cuda"][0]
    check(post["x"]["r"].shape == (PHASE_12_N, 2)
          and bool(torch.isfinite(post["x"]["r"]).all()),
          "phase 12 L21 GLM: x posterior not finite or of another shape")
    card_against_cpu(torch, f"phase 12 prior L21_norm in a GLM, (N, 2) x "
                     f"through W ({M} x {PHASE_12_N}), EP", res["cpu"][0],
                     res["cpu"][1], post, res["cuda"][1], ("x", "z"))
    mse = float(((post["x"]["r"].cpu() - torch.as_tensor(x0)) ** 2).mean())
    print(f"phase 12 prior L21_norm in a GLM: EP n_iter="
          f"{int(res['cuda'][1])} conv={bool(res['cuda'][2])} "
          f"mse={mse:.6g} (signal power {float(np.mean(x0**2)):.6g}) "
          f"[{card}]")
    # the committee-binary prior takes a K x K precision, and the EP
    # engine (the JAX package's too) passes one number: its denoiser
    # x -> + noise -> y, whose EP is exact in one step, is solved with the
    # channel's message a = I / var, b = y / var written out
    K, var = 3, 1e-1
    prior = CommitteeBinaryPrior(N=PHASE_12_N, K=K, p_pos=0.4, device="cpu",
                                 dtype=f64)
    ax = torch.eye(K, dtype=f64) / var
    bx = prior.sample(torch.Generator().manual_seed(4)) / var \
        + torch.as_tensor(rng.randn(PHASE_12_N, K), dtype=f64) / np.sqrt(var)
    post = {}
    for device in ("cpu", "cuda"):
        r, v = prior.compute_forward_posterior(ax.to(device), bx.to(device))
        logz = prior.compute_log_partition(ax.to(device), bx.to(device))
        post[device] = {"x": {"r": r, "v": v}, "prior": {"logZ": logz}}
    card_against_cpu(torch, f"phase 12 prior committee_binary (N="
                     f"{PHASE_12_N}, K={K}) denoiser, var {var:g}",
                     post["cpu"], None, post["cuda"], None, ("x",))
    card_against_cpu(torch, "phase 12 prior committee_binary log-partition",
                     post["cpu"], None, post["cuda"], None, ("prior",),
                     keys=("logZ",))
    print(f"phase 12 prior committee_binary: the denoiser's posterior in "
          f"one step (no EPSolver: the engine passes a scalar precision, the "
          f"prior takes a K x K one), v diagonal "
          f"{[round(float(d), 6) for d in post['cuda']['x']['v'].diag()]}, "
          f"log-partition {float(post['cuda']['prior']['logZ']):.6g} "
          f"[{card}]")
    launches = read_launches(pl)
    check(not any(launches.values()), f"phase 12 ran kernels: {launches}")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# -- phase 13: the structured channels, total variation, low rank, tanh ------
SPARSE_GRADIENT = dict(N=400, rho=0.04, noise_var=1e-2, seed=1)
SG_SOLVE = dict(damping=0.1, max_iter=1000, tol=1e-6)   # bench.py:567
SG_BOUND = 5e-2        # bench.py:114-115, f32 against f64 in v and MSE
TREE = dict(N=2048, M=1024, rho=0.05, lanes=256)    # bench.py:1303-1325
TREE_SOLVE = dict(damping=0.1, max_iter=1000, tol=1e-5)
IMAGE = 64             # the examples' --big size
IMAGE_NOISE = 0.1
LOW_RANK = dict(M=512, N=512, K=2, seeds=16,
                deltas=(0.1, 0.2, 0.4, 0.7, 1.0))   # bench.py:1378-1387
#: the low-rank solves held element by element: run to a tight tol
LOW_RANK_TIGHT = dict(tol=1e-12, max_iter=5000)
LOW_RANK_TIGHT_RTOL = 1e-8
LOW_RANK_EP = dict(width=512, K=2, delta_uv=0.1, delta_gram=0.05,
                   damping=0.3, max_iter=20)
TANH_N = 4096


def sparse_gradient_student(torch, dtype, device="cuda",
                            config=SPARSE_GRADIENT):
    """BASELINE config 3's student (bench.py:536-570): x with a Gaussian
    prior observed through Gaussian noise, its gradient Gauss-Bernoulli
    (size (1, N)); teacher x0 the centred cumulative sum of a sparse draw.
    Returns (student, x0)."""
    from tramp_tpu_torch.channels import GaussianChannel, GradientChannel
    from tramp_tpu_torch.priors import GaussBernoulliPrior, GaussianPrior
    from tramp_tpu_torch.variables import (
        MILeafVariable, SIMOVariable, SILeafVariable)
    N, rho, noise = config["N"], config["rho"], config["noise_var"]
    rng = np.random.RandomState(config["seed"])
    z0 = (rng.rand(1, N) < rho) * rng.randn(1, N)
    x0 = z0.ravel().cumsum()
    x0 = x0 - x0.mean()
    y = x0 + np.sqrt(noise) * rng.randn(N)
    dkw = dict(device=device, dtype=dtype)
    student = (
        GaussianPrior(size=(N,), **dkw) @
        SIMOVariable(id="x", n_next=2) @ (
            GaussianChannel(var=noise) @ SILeafVariable(id="y") + (
                GradientChannel(shape=(N,), **dkw) +
                GaussBernoulliPrior(size=(1, N), rho=rho, **dkw)
            ) @ MILeafVariable(id="z", n_prev=2))
    ).to_model()
    y = torch.as_tensor(y, device=device, dtype=dtype)
    return student.to_observed({"y": y}), x0


def phase_13a_sparse_gradient(torch, tt, pl, card):
    """BASELINE config 3 through EPSolver in float32 and float64 with
    bench.py's bounds, a profiled loop window, and float64 on the card
    against the CPU. Returns the launches."""
    from tramp_tpu_torch.parallel import EPSolver
    reset_launches(pl)
    res = {}
    for dtype in (torch.float32, torch.float64):
        student, x0 = sparse_gradient_student(torch, dtype)
        solver = EPSolver(student, **SG_SOLVE)
        solver.solve(student)                               # warm-up
        out = {}
        wall = timed_solve(torch, lambda: out.update(
            res=solver.solve_info(student)))
        post, n_iter, conv = out["res"]
        r = post["x"]["r"].double().cpu().numpy()
        check(np.isfinite(r).all() and r.shape == x0.shape,
              f"sparse gradient {dtype_name(dtype)}: r not finite")
        mse, v = float(np.mean((r - x0) ** 2)), float(post["x"]["v"])
        res[dtype_name(dtype)] = (mse, v)
        print(f"sparse gradient (BASELINE config 3, N={x0.size}, rho 0.04) "
              f"{dtype_name(dtype)} through EPSolver: n_iter={int(n_iter)} "
              f"conv={bool(conv)} mse={mse:.6g} v={v:.6g} wall={wall:.3f} s "
              f"[{card}]")
    launches = read_launches(pl)
    (m32, v32), (m64, v64) = res["float32"], res["float64"]
    v_rel, mse_rel = abs(v32 - v64) / v64, abs(m32 - m64) / m64
    check(v_rel < SG_BOUND and mse_rel < SG_BOUND,
          f"sparse gradient f32 vs f64: v {v_rel:.3g}, mse {mse_rel:.3g} "
          f"(bound {SG_BOUND})")
    print(f"sparse gradient f32 vs f64 (bench.py:114-115): v rel err "
          f"{v_rel:.3e}, mse rel err {mse_rel:.3e} (bound {SG_BOUND})")
    student, _ = sparse_gradient_student(torch, torch.float32)
    print_window("sparse gradient float32, one instance, EPSolver",
                 loop_window(lambda k: EPSolver(student, **dict(
                     SG_SOLVE, max_iter=k, tol=0.0,
                     rollback_increase=float("inf"))).solve(student)), card)
    cpu, _ = sparse_gradient_student(torch, torch.float64, device="cpu")
    gpu = on_card(torch, cpu)
    cpu_post, cpu_n, _ = EPSolver(cpu, **SG_SOLVE).solve_info(cpu)
    gpu_post, gpu_n, _ = EPSolver(gpu, **SG_SOLVE).solve_info(gpu)
    card_against_cpu(torch, "sparse gradient N=400 f64 through EPSolver",
                     cpu_post, cpu_n, gpu_post, gpu_n, ("x", "z"))
    check(not any(launches.values()), f"sparse gradient ran {launches}")
    return launches


def phase_13b_tree_lanes(torch, tt, pl, card):
    """The sparse-gradient regression tree at bench_tree_carry's size:
    TREE["lanes"] lanes on one A, a teacher and a y each, float32, through
    EPSolver.solve_batch; three lanes against their single solves; the
    readings of phase 7. Returns the launches."""
    from tramp_tpu_torch.parallel import EPSolver, with_buffers
    N, M, lanes = TREE["N"], TREE["M"], TREE["lanes"]
    rng = np.random.RandomState(0)
    A = rng.randn(M, N) / np.sqrt(N)
    x0 = np.cumsum(rng.randn(lanes, N) * (rng.rand(lanes, N) < TREE["rho"]),
                   axis=1)
    ys = x0 @ A.T + 0.1 * rng.randn(lanes, M)
    f32 = dict(device="cuda", dtype=torch.float32)
    model = tt.models.sparse_gradient_regression(
        A, ys[0], x_shape=(N,), grad_rho=TREE["rho"], noise_var=1e-2,
        prior_var=1.0, **f32)
    index = next(i for i, f in enumerate(model.factors)
                 if type(f).__name__ == "GaussianLikelihood")
    ys = torch.as_tensor(ys, **f32)
    stacked = with_buffers(model, {(index, "y"): ys})
    solver = EPSolver(model, **TREE_SOLVE)
    what = (f"sparse-gradient regression tree N={N} M={M} float32, "
            f"EPSolver.solve_batch over {lanes} lanes")
    w = print_window(what, loop_window(lambda k: EPSolver(model, **dict(
        TREE_SOLVE, max_iter=k, tol=0.0,
        rollback_increase=float("inf"))).solve_batch(stacked)), card)
    post, n_iter, conv, launches = batched_solve(
        torch, pl, what, lambda: _ep_batch(solver, stacked), lanes, card, w)
    mse = ((post["x"]["r"].double().cpu() - torch.as_tensor(x0)) ** 2).mean(1)
    print(f"{what}: launches per iteration {w['kernels']:.1f}; mse of x per "
          f"lane {float(mse.min()):.4g} to {float(mse.max()):.4g} (mean "
          f"{float(mse.mean()):.4g}); iterations per lane, largest first: "
          f"{sorted(n_iter.tolist(), reverse=True)[:5]}")
    lanes_against_singles(torch, what, solver, model, index, ys, post,
                          n_iter)
    check(not any(launches.values()), f"{what}: ran kernels {launches}")
    return launches


def make_image(H, W, rng):
    "examples/sparse/image_denoising.py's piecewise-constant image."
    x = np.zeros((H, W))
    for _ in range(6):
        r0, c0 = rng.randint(0, H - 4), rng.randint(0, W - 4)
        r1, c1 = rng.randint(r0 + 2, H), rng.randint(c0 + 2, W)
        x[r0:r1, c0:c1] += rng.randn()
    return (x - x.mean()) / x.std()


def phase_13c_images(torch, tt, pl, card):
    """The 2-D channels on 64 x 64 images, float64: the denoising example
    with a sparse-gradient and a TV prior on the 2-D gradient (bound: mse <
    noise / (1 + noise)), the deconvolution example through Blur2DChannel
    (bound: mse_ep < mse of the blurred observation), and tv_regression
    through EPSolver on the card against the CPU. Returns the launches."""
    from tramp_tpu_torch.algos import ConstantInit, EarlyStoppingEP
    from tramp_tpu_torch.channels import (
        Blur2DChannel, GaussianChannel, GradientChannel)
    from tramp_tpu_torch.parallel import EPSolver
    from tramp_tpu_torch.priors import (
        GaussBernoulliPrior, GaussianPrior, MAP_L21NormPrior)
    from tramp_tpu_torch.variables import (
        MILeafVariable, SIMOVariable, SILeafVariable)
    reset_launches(pl)
    dkw = dict(device="cuda", dtype=torch.float64)
    H = W = IMAGE
    noise = IMAGE_NOISE
    rng = np.random.RandomState(0)
    x0 = make_image(H, W, rng)
    y = x0 + np.sqrt(noise) * rng.randn(H, W)
    g = np.stack(np.gradient(x0))
    nz = np.abs(g) > 0.05
    bound = noise / (1 + noise)
    priors = {
        "sparse-gradient": GaussBernoulliPrior(
            size=(2, H, W), rho=float(nz.mean()), var=float(g[nz].var()),
            **dkw),
        "TV": MAP_L21NormPrior(size=(2, H, W), gamma=1.0, axis=0, **dkw)}
    for name, grad_prior in priors.items():
        student = (
            GaussianPrior(size=(H, W), **dkw) @
            SIMOVariable(id="x", n_next=2) @ (
                GaussianChannel(var=noise) @ SILeafVariable(id="y") + (
                    GradientChannel(shape=(H, W), **dkw) + grad_prior
                ) @ MILeafVariable(id="x'", n_prev=2))
        ).to_model().to_observed({"y": torch.as_tensor(y, **dkw)})
        ep = tt.ExpectationPropagation(student)

        def run():
            if name == "TV":
                ep.iterate(max_iter=100, damping=0.0,
                           initializer=ConstantInit(a=1, b=1))
            else:
                ep.iterate(max_iter=200, damping=0.1,
                           callback=EarlyStoppingEP())
        wall = timed_solve(torch, run)
        r = ep.get_variable_data("x")["r"].cpu().numpy()
        mse = float(np.mean((r - x0) ** 2))
        check(np.isfinite(r).all() and mse < bound,
              f"image denoising {name}: mse {mse:.4g} (bound {bound:.4g})")
        print(f"image denoising {H}x{W} f64, {name} prior on the 2-D "
              f"gradient: n_iter={ep.n_iter} mse={mse:.6g} < noise/(1+noise)"
              f" = {bound:.4g} (noisy {float(np.mean((y - x0) ** 2)):.4g}), "
              f"wall={wall:.3f} s [{card}]")
        if name == "sparse-gradient":
            kernels, device, wall_ms = sweep_window(ep)
            print(f"image denoising {H}x{W} f64, sparse-gradient prior, "
                  f"torch.profiler over 10 warm sweeps: {kernels:.1f} kernels "
                  f"per sweep, device {device:.4f} ms of {wall_ms:.4f} ms, "
                  f"busy {100 * device / wall_ms:.2f}% [{card}]")
    # deconvolution (examples/sparse/image_deconvolution.py)
    rng = np.random.RandomState(0)
    x0 = make_image(H, W, rng)
    sigma = H / 16.0
    blur = Blur2DChannel(sigma=(sigma, sigma), shape=(H, W), **dkw)
    y = blur.sample(None, torch.as_tensor(x0, **dkw)).cpu().numpy()
    y = y + np.sqrt(noise) * rng.randn(H, W)
    student = (
        GaussianPrior(size=(H, W), **dkw) @ tt.V(id="x") @
        Blur2DChannel(sigma=(sigma, sigma), shape=(H, W), **dkw) @
        tt.V(id="z") @ GaussianChannel(var=noise) @ tt.O(id="y")
    ).to_model().to_observed({"y": torch.as_tensor(y, **dkw)})
    ep = tt.ExpectationPropagation(student)
    wall = timed_solve(torch, lambda: ep.iterate(max_iter=100))
    r = ep.get_variable_data("x")["r"].cpu().numpy()
    mse_ep, mse_blurred = (float(np.mean((r - x0) ** 2)),
                           float(np.mean((y - x0) ** 2)))
    check(np.isfinite(r).all() and mse_ep < mse_blurred,
          f"deconvolution: mse {mse_ep:.4g}, blurred {mse_blurred:.4g}")
    print(f"deconvolution {H}x{W} f64 through Blur2DChannel (sigma "
          f"{sigma:g}): n_iter={ep.n_iter} mse_ep={mse_ep:.6g} < "
          f"mse_blurred={mse_blurred:.6g}, wall={wall:.3f} s [{card}]")
    # tv_regression, card against CPU
    shape = (16, 16)
    N = int(np.prod(shape))
    rng = np.random.RandomState(4)
    A = rng.randn(3 * N // 4, N) / np.sqrt(N)
    xt = make_image(*shape, rng).ravel()
    y = A @ xt + 0.1 * rng.randn(A.shape[0])
    cpu = tt.models.tv_regression(A, y, x_shape=shape, grad_scale=1.0,
                                  noise_var=1e-2, prior_var=1.0,
                                  device="cpu", dtype=torch.float64)
    gpu = on_card(torch, cpu)
    kw = dict(damping=0.1, max_iter=200, tol=1e-6)
    init = ConstantInit(a=1.0, b=1.0)
    cpu_post, cpu_n, _ = EPSolver(cpu, **kw).solve_info(cpu, init)
    gpu_post, gpu_n, conv = EPSolver(gpu, **kw).solve_info(gpu, init)
    card_against_cpu(torch, f"tv_regression {shape} f64 through EPSolver",
                     cpu_post, cpu_n, gpu_post, gpu_n, ("x", "x'", "z"))
    mse = float(np.mean((gpu_post["x"]["r"].cpu().numpy()
                         - xt.reshape(shape)) ** 2))
    print(f"tv_regression {shape}: n_iter={int(gpu_n)} conv={bool(conv)} "
          f"mse={mse:.6g} [{card}]")
    launches = read_launches(pl)
    check(not any(launches.values()), f"phase 13c ran kernels {launches}")
    return launches


def low_rank_instances(Delta, seeds, M, N, K):
    "bench.py:1398-1411's planted UV instances (numpy, f64 cast to f32)."
    X0s, bxs = [], []
    for s in range(seeds):
        rng = np.random.RandomState(1000 * s)
        u0 = rng.randn(M, K)
        v0 = rng.randn(N, K)
        X0 = u0 @ v0.T / np.sqrt(N)
        Y = X0 + np.sqrt(Delta) * rng.randn(M, N)
        X0s.append(X0.astype(np.float32))
        bxs.append((Y / Delta).astype(np.float32))
    return np.stack(X0s), np.stack(bxs)


def phase_13d_low_rank_sweep(torch, tt, pl, card):
    """bench.py:1393-1480 on the card: M = N = 512, K = 2, 16 seeds per
    Delta, one batched solve of 16 lanes per Delta, float32 (TF32 off), each
    Delta's empirical x-space MSE within the bench's band of the K x K SE
    prediction; instances/s; in float64, run to tol 1e-12, two of 4 lanes
    against their single solves and M = N = 128 on the card against the
    CPU, its loop count within the CPU's own spread under a 1e-15 change
    of bx. The float32 lane against its single solve
    at the bench's tol 1e-5 is a reading: a rounding difference of the
    batch moves that end point by about 1e-3."""
    from tramp_tpu_torch.channels.low_rank import (
        se_matrix_factorization_kk, vamp_matrix_factorization)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the low-rank solver needs full float32 products")
    M, N, K, S = (LOW_RANK[k] for k in ("M", "N", "K", "seeds"))
    f32 = dict(device="cuda", dtype=torch.float32)
    bu, bv = torch.zeros((M, K), **f32), torch.zeros((N, K), **f32)
    data = {d: low_rank_instances(d, S, M, N, K) for d in LOW_RANK["deltas"]}

    def solve(Delta, bx, stats=None):
        return vamp_matrix_factorization(
            au=1.0, av=1.0, bu=bu, bv=bv, ax=1.0 / Delta, bx=bx, model="UV",
            stats=stats)

    d0 = LOW_RANK["deltas"][0]
    solve(d0, torch.as_tensor(data[d0][1], **f32))           # warm-up
    total, devs = 0.0, []
    for Delta in LOW_RANK["deltas"]:
        X0s, bxs = data[Delta]
        bx = torch.as_tensor(bxs, **f32)
        stats, out = {}, {}
        wall = timed_solve(torch, lambda: out.update(r=solve(Delta, bx,
                                                             stats)))
        total += wall
        ru, vu, rv, vv = out["r"]
        Xh = torch.einsum("smk,snk->smn", ru.double(), rv.double()) / \
            math.sqrt(N)
        mses = ((Xh.cpu() - torch.as_tensor(X0s).double()) ** 2).mean((1, 2))
        emp, sd = float(mses.mean()), float(mses.std(unbiased=False)
                                            / math.sqrt(S))
        mse_u, mse_v = se_matrix_factorization_kk(
            au=1.0, av=1.0, ax=1.0 / Delta, model="UV", K=K, alpha=M / N,
            damping=0.5, device="cuda")
        q_u = torch.eye(K, dtype=torch.float64) - mse_u.cpu()
        q_v = torch.eye(K, dtype=torch.float64) - mse_v.cpu()
        pred = float((K - torch.trace(q_u @ q_v)) / N)
        dev = abs(emp - pred) / (3 * sd + 0.1 * pred)
        devs.append(dev)
        check(math.isfinite(dev) and dev <= 1.0,
              f"low rank Delta {Delta}: mse_x {emp:.4g} vs SE {pred:.4g}, "
              f"dev {dev:.3g} > 1")
        print(f"low rank UV M=N={N} K={K} Delta={Delta} f32, {S} lanes in "
              f"one solve: {stats['iterations']} iterations of the loop, "
              f"{wall:.4f} s; mse_x {emp:.6g} (sd of mean {sd:.3g}) vs SE "
              f"{pred:.6g}, dev {dev:.3f} <= 1; vz_u "
              f"{float(vu.mean()):.5g} [{card}]")
        if Delta == 0.4:
            one = {}
            r1 = solve(Delta, bx[0], one)
            X1 = (r1[0].double() @ r1[2].double().T / math.sqrt(N)).cpu()
            print(f"low rank Delta 0.4 f32: lane 0 vs its single solve "
                  f"(reading): x within "
                  f"{rel_to_largest(torch, Xh[0].cpu(), X1):.3e} of the "
                  f"largest |x|, {one['iterations']} iterations alone; the "
                  "solve's stop (tol 1e-5) resolves its fixed point to about "
                  "1e-3 after a chaotic start")
    n = S * len(LOW_RANK["deltas"])
    print(f"low rank Delta sweep: {n} instances in {total:.4f} s, "
          f"{n / total:.2f} instances/s, worst dev {max(devs):.3f} [{card}]")
    # one iteration of the solver's loop: run(k) runs exactly k iterations
    bx = torch.as_tensor(data[0.4][1], **f32)
    print_window(f"low rank solver, {S} lanes of {M} x {N} f32, Delta 0.4",
                 loop_window(lambda k: vamp_matrix_factorization(
                     au=1.0, av=1.0, bu=bu, bv=bv, ax=2.5, bx=bx,
                     model="UV", max_iter=k - 1, min_iter=k, tol=0.0)), card)
    # lanes against single solves and the card against the CPU, float64,
    # each solve run to LOW_RANK_TIGHT's tol: a perturbation of 1e-13 of
    # bx moves that fixed point by 1e-10 of the largest |x| (at the bench's
    # tol 1e-5 by 1e-3: the first iterations amplify rounding by 1e9)
    _, bxs = low_rank_instances(0.4, 4, M, N, K)
    f64 = dict(device="cuda", dtype=torch.float64)

    def tight(bx, M, N, stats=None, **kw):
        r = vamp_matrix_factorization(
            au=1.0, av=1.0, bu=torch.zeros((M, K), **kw),
            bv=torch.zeros((N, K), **kw), ax=2.5, bx=bx, model="UV",
            stats=stats, **LOW_RANK_TIGHT)
        X = torch.einsum("...mk,...nk->...mn", r[0], r[2]) / math.sqrt(N)
        return X.cpu(), r[1].reshape(-1).cpu()

    stats = {}
    X4, _ = tight(torch.as_tensor(bxs, **f64), M, N, stats, **f64)
    for lane in (0, 3):
        one = {}
        X1, _ = tight(torch.as_tensor(bxs[lane], **f64), M, N, one, **f64)
        err = rel_to_largest(torch, X4[lane], X1)
        check(err < LOW_RANK_TIGHT_RTOL,
              f"low rank f64: lane {lane} is {err:.3g} of the largest |x| "
              f"off its single solve (bound {LOW_RANK_TIGHT_RTOL})")
        print(f"low rank M=N={N} Delta 0.4 f64, 4 lanes at tol "
              f"{LOW_RANK_TIGHT['tol']:g}: lane {lane} vs its single solve: "
              f"x within {err:.3e} of the largest |x| (bound "
              f"{LOW_RANK_TIGHT_RTOL}); {stats['iterations']} iterations for "
              f"the batch, {one['iterations']} alone")
    M2 = 128
    _, bxs = low_rank_instances(0.4, 1, M2, M2, K)
    post, loops = {}, {}
    for device in ("cpu", "cuda"):
        kw = dict(device=device, dtype=torch.float64)
        loops[device] = {}
        X, v = tight(torch.as_tensor(bxs[0], **kw), M2, M2, loops[device],
                     **kw)
        post[device] = {"x": {"r": X, "v": v}}
    what = (f"low rank UV M=N={M2} Delta 0.4 f64 at tol "
            f"{LOW_RANK_TIGHT['tol']:g}, x = u v^T / sqrt(N)")
    card_against_cpu(torch, what, post["cpu"], None, post["cuda"], None,
                     ("x",))
    # The loop counts: where the stop fires moves with rounding (about 7
    # iterations per decade of the diff), so the card's count is held to
    # the spread of the CPU's own count when bx moves by 1e-15 of itself.
    cpu = dict(device="cpu", dtype=torch.float64)
    bx = torch.as_tensor(bxs[0], **cpu)
    gen = torch.Generator().manual_seed(0)
    counts = [loops["cpu"]["iterations"]]
    for _ in range(4):
        one = {}
        tight(bx * (1.0 + 1e-15 * torch.randn(bx.shape, generator=gen,
                                              **cpu)), M2, M2, one, **cpu)
        counts.append(one["iterations"])
    lo, hi = min(counts), max(counts)
    n_card = loops["cuda"]["iterations"]
    check(lo - (hi - lo) <= n_card <= hi + (hi - lo),
          f"{what}: {n_card} loop iterations on the card, {counts} on the "
          f"CPU with bx moved by 1e-15")
    print(f"{what}: {n_card} loop iterations on the card, {counts[0]} on the "
          f"CPU and {counts[1:]} there with bx moved by 1e-15 of itself "
          f"(band [{lo - (hi - lo)}, {hi + (hi - lo)}])")


def low_rank_ep_models(torch, tt, device, dtype, seed=0):
    """tests/test_low_rank_activation.py:326-388's two models at
    LOW_RANK_EP's width: (UV model, factor, X0), (Gram model, factor, X0)."""
    from tramp_tpu_torch.channels import (
        LowRankFactorization, LowRankGramChannel)
    from tramp_tpu_torch.likelihoods import GaussianLikelihood
    from tramp_tpu_torch.priors import GaussianPrior
    dkw = dict(device=device, dtype=dtype)
    n, K = LOW_RANK_EP["width"], LOW_RANK_EP["K"]
    rng = np.random.RandomState(seed)
    u0, v0 = rng.randn(n, K), rng.randn(n, K)
    X0 = u0 @ v0.T / np.sqrt(n)
    Y = X0 + np.sqrt(LOW_RANK_EP["delta_uv"]) * rng.randn(n, n)
    uv = LowRankFactorization(M=n, N=n, K=K)
    uv_model = (
        (GaussianPrior(size=(n, K), **dkw) @ tt.V(id="u") +
         GaussianPrior(size=(n, K), **dkw) @ tt.V(id="v")) @
        uv @ tt.V(id="x") @
        GaussianLikelihood(y=Y, var=LOW_RANK_EP["delta_uv"], **dkw)
    ).to_model()
    rng = np.random.RandomState(seed)
    z0 = rng.randn(n, K)
    Z0 = z0 @ z0.T / np.sqrt(n)
    E = rng.randn(n, n)
    Yg = Z0 + np.sqrt(LOW_RANK_EP["delta_gram"]) * (E + E.T) / np.sqrt(2)
    gram = LowRankGramChannel(N=n, K=K)
    gram_model = (
        GaussianPrior(size=(n, K), **dkw) @ tt.V(id="z") @ gram
        @ tt.V(id="x") @
        GaussianLikelihood(y=Yg, var=LOW_RANK_EP["delta_gram"], **dkw)
    ).to_model()
    return (uv_model, uv, X0), (gram_model, gram, Z0)


def phase_13e_low_rank_ep(torch, tt, pl, card):
    """LowRankFactorization and LowRankGramChannel inside the EP engine at
    tests/test_low_rank_activation.py:326-388's protocol, 512 wide, float32:
    the x posterior's MSE under 0.25 of the signal power; the embedded
    solves' iterations per sweep (a sweep's cost is about that many
    iterations of the loop profiled in 13d, twice). Returns the
    launches."""
    reset_launches(pl)
    for (model, factor, X0), name in zip(
            low_rank_ep_models(torch, tt, "cuda", torch.float32),
            ("LowRankFactorization", "LowRankGramChannel")):
        ep = tt.ExpectationPropagation(model)
        wall = timed_solve(torch, lambda: ep.iterate(
            max_iter=LOW_RANK_EP["max_iter"],
            damping=LOW_RANK_EP["damping"]))
        Xh = ep.get_variable_data("x")["r"].double().cpu().numpy()
        tau = float(np.mean(X0**2))
        mse = float(np.mean((Xh - X0) ** 2))
        check(np.isfinite(Xh).all() and mse < 0.25 * tau,
              f"{name} EP: mse_x {mse:.4g}, 0.25 tau_x {0.25 * tau:.4g}")
        st = factor.stats
        print(f"{name} in the EP engine, {LOW_RANK_EP['width']} wide, f32: "
              f"n_iter={ep.n_iter} mse_x={mse:.6g} < 0.25 tau_x = "
              f"{0.25 * tau:.6g}; {st.get('solves', 0)} embedded solves, "
              f"{st.get('iterations', 0) / max(ep.n_iter, 1):.1f} solver "
              f"iterations per sweep, wall={wall:.3f} s [{card}]")
    launches = read_launches(pl)
    check(not any(launches.values()), f"phase 13e ran kernels {launches}")
    return launches


def tanh_net(torch, tt, dtype, N=TANH_N, alpha=0.5, device="cuda",
             svd=None):
    """The relu net of phase 4 (RandomState(11)) with tanh in place of
    relu. Returns (student, x0, linear)."""
    from tramp_tpu_torch.channels import (
        GaussianChannel, LinearChannel, TanhChannel)
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    M = int(alpha * N)
    rng = np.random.RandomState(11)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = (rng.rand(N) < RHO) * rng.randn(N)
    y = np.tanh(W @ x0) + np.sqrt(NOISE) * rng.randn(M)
    linear = LinearChannel(W, name="W", svd=svd, device=device, dtype=dtype)
    teacher = (
        GaussBernoulliPrior(size=N, rho=RHO, device=device, dtype=dtype)
        @ tt.V(id="x") @ linear @ tt.V(id="z") @ TanhChannel()
        @ tt.V(id="a") @ GaussianChannel(var=NOISE) @ tt.O(id="y")
    ).to_model()
    y = torch.as_tensor(y, device=device, dtype=dtype)
    return teacher.to_observed({"y": y}), x0, linear


def phase_13f_tanh(torch, tt, pl, card):
    """TanhChannel mid-graph at the relu net's shape: f32 against f64 in v
    and MSE within 5e-2 (bench.py:118-119's band), a profiled sweep window,
    N = 256 f64 on the card against the CPU, and no piecewise-linear
    launch. Returns the launches."""
    results = {}
    launches = {}
    for dtype in (torch.float32, torch.float64):
        student, x0, _ = tanh_net(torch, tt, dtype)
        ep, mse, v, wall, got = solve(torch, tt, pl, student, x0)
        launches = {k: launches.get(k, 0) + n for k, n in got.items()}
        results[dtype_name(dtype)] = (mse, v)
        print(f"tanh net N={TANH_N} {dtype_name(dtype)}: n_iter={ep.n_iter} "
              f"mse={mse:.6g} v={v:.6g} wall={wall:.3f} s [{card}]")
        if dtype == torch.float32:
            kernels, device, wall_ms = sweep_window(ep)
            print(f"tanh net N={TANH_N} f32, torch.profiler over 10 warm "
                  f"sweeps: {kernels:.1f} kernels per sweep, device "
                  f"{device:.4f} ms of {wall_ms:.4f} ms, busy "
                  f"{100 * device / wall_ms:.2f}% [{card}]")
    (m32, v32), (m64, v64) = results["float32"], results["float64"]
    v_rel, mse_rel = abs(v32 - v64) / v64, abs(m32 - m64) / m64
    check(v_rel < V_MSE_BOUND and mse_rel < V_MSE_BOUND,
          f"tanh net f32 vs f64: v {v_rel:.3g}, mse {mse_rel:.3g}")
    print(f"tanh net f32 vs f64: v rel err {v_rel:.3e}, mse rel err "
          f"{mse_rel:.3e} (bound {V_MSE_BOUND})")
    cpu, _, lin = tanh_net(torch, tt, torch.float64, N=256, device="cpu")
    gpu, _, _ = tanh_net(torch, tt, torch.float64, N=256,
                         svd=(lin.U, lin.s, lin.V.T))
    cpu_ep = tt.ExpectationPropagation(cpu).iterate(**SOLVE)
    reset_launches(pl)
    gpu_ep = tt.ExpectationPropagation(gpu).iterate(**SOLVE)
    launches = {k: launches[k] + n for k, n in read_launches(pl).items()}
    card_against_cpu(torch, "tanh net N=256 f64 through the engine",
                     {"x": cpu_ep.get_variable_data("x")}, cpu_ep.n_iter,
                     {"x": gpu_ep.get_variable_data("x")}, gpu_ep.n_iter,
                     ("x",))
    check(not any(launches.values()), f"tanh net ran kernels {launches}")
    return launches


def phase_13(torch, tt, pl, card):
    """Phase 13: the structured channels, total variation, the low-rank
    family and the tanh channel. Returns the launches by path, each path's
    counts set to 0 just before it and read just after (all 0: none of
    these factors reaches the piecewise-linear kernels)."""
    t0 = time.perf_counter()
    paths, seconds = {}, {}

    def lap(part):
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    paths["sparse_gradient_ep"] = phase_13a_sparse_gradient(
        torch, tt, pl, card)
    lap("a")
    paths["sparse_gradient_tree_batch"] = phase_13b_tree_lanes(
        torch, tt, pl, card)
    lap("b")
    paths["images_2d_ep"] = phase_13c_images(torch, tt, pl, card)
    lap("c")
    reset_launches(pl)
    phase_13d_low_rank_sweep(torch, tt, pl, card)
    paths["low_rank_delta_sweep"] = read_launches(pl)
    lap("d")
    paths["low_rank_ep"] = phase_13e_low_rank_ep(torch, tt, pl, card)
    lap("e")
    paths["tanh_ep"] = phase_13f_tanh(torch, tt, pl, card)
    lap("f")
    for path, launches in paths.items():
        check(not any(launches.values()),
              f"phase 13 {path} ran piecewise-linear kernels: {launches}")
    print(f"phase 13: {time.perf_counter() - t0:.1f} s, by part "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; pl_fused launches 0 on every path [{card}]")
    return paths


ADAPTIVE_SWEEPS = 8    # sweeps of the adaptive EP runs of phase 14a
# pl_posterior launches of one adaptive EP sweep of the relu net after the
# first (undamped) one: two slots go into the relu factor (z -> relu and
# a -> relu), and each of their writes scores the old message and 10
# candidates with the factor's log-partition, one launch each
ADAPTIVE_PL_POSTERIOR = 2 * (1 + 10)
# update_dA: each of the two writes into the relu factor scores the new and
# the old message
DA_PL_POSTERIOR = 2 * 2
TRACE_SWEEPS = 50
EXTRAS_N = 256          # card against CPU, float64
BATCH_SPLIT = 5         # the batched solves are interrupted after it
# the Bethe objective of an adaptive run may fall by rounding from the
# second sweep on: bound relative to its largest magnitude over the run
OBJECTIVE_ROUNDING = {"float32": 1e-4, "float64": 1e-10}
TRACE_RTOL = {"float32": 1e-5, "float64": 1e-10}
FLIP_RTOL = 1e-6        # card against CPU where accept decisions differ


def extras_dir():
    "A scratch directory of phase 14 inside the checkout (git-ignored)."
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "phase14")
    os.makedirs(path, exist_ok=True)
    return path


def recording_engine(tt):
    """The EP engine, recording every local Bethe objective an adaptive
    write scores (the old message, then the candidates from the smallest
    beta up), so that two runs' accept decisions can be compared."""
    class Recording(tt.ExpectationPropagation):
        def __init__(self, model):
            super().__init__(model)
            self.scored = []

        def _local_objective(self, state, s, msg, aux=None):
            A = super()._local_objective(state, s, msg, aux)
            self.scored.append(A.reshape(()))
            return A

    return Recording


def accept_choices(torch, engine, n_max=10):
    """The beta each adaptive write kept, as its exponent n of 1/2^n (-1:
    the old message), from the objectives the recording engine scored."""
    scores = torch.stack(engine.scored).double().cpu().reshape(-1, n_max + 1)
    ok = (scores[:, 1:] - scores[:, :1]) >= 0     # n = n_max - 1 ... 0
    # the largest beta that passes wins: the last column with ok
    last = torch.where(ok, torch.arange(n_max), -1).amax(1)
    return torch.where(last >= 0, n_max - 1 - last, -1)


def same_state(torch, a, b):
    return len(a) == len(b) and all(
        set(m) == set(n) and all(torch.equal(m[k], n[k]) for k in m)
        for m, n in zip(a, b))


def sweep_readings(torch, pl, sweep, reps=3):
    """(launches by kernel, kernels, device ms, wall ms, pl_posterior
    device ms) of one warm sweep, from torch.profiler over ``reps`` calls
    of ``sweep()`` (launches from the wrappers' counts over one call)."""
    sweep()
    torch.cuda.synchronize()
    reset_launches(pl)
    sweep()
    torch.cuda.synchronize()
    launches = read_launches(pl)
    events, wall = device_events(sweep, reps)
    check(events, "torch.profiler shows no device time")
    kernels = [e for e in events
               if not e.name.lower().startswith(("memcpy", "memset"))]
    device = 1e-3 * sum(e.time_range.elapsed_us() for e in events) / reps
    post = 1e-3 * sum(e.time_range.elapsed_us() for e in events
                      if "pl_posterior" in e.name) / reps
    return launches, len(kernels) / reps, device, 1e3 * wall / reps, post


def phase_14a_adaptive_ep(torch, tt, pl, students, card):
    """Adaptive EP on the relu net (N = 4096) in float32 and float64, and
    card against CPU at N = 256. Returns (launches by path, readings of
    the profiled adaptive sweep)."""
    from tramp_tpu_torch.channels import ReluChannel
    paths, readings = {}, {}
    K = ADAPTIVE_SWEEPS
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        student = students[dname][0]
        tt.ExpectationPropagation(student).iterate(
            max_iter=2, damping="adaptive", tol=0.0)      # warm-up
        torch.cuda.synchronize()
        reset_launches(pl)
        t0 = time.perf_counter()
        ep = tt.ExpectationPropagation(student).iterate(
            max_iter=K, damping="adaptive", tol=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = paths[f"adaptive_ep_relu_net_{dname}"] = read_launches(pl)
        want = {"pl_posterior": ADAPTIVE_PL_POSTERIOR * (K - 1),
                "pl_forward_message": K, "pl_backward_message": K}
        check(ep.n_iter == K and launches == want,
              f"adaptive EP {dname}: {ep.n_iter} sweeps, launches "
              f"{launches}, want {want}")
        objectives = []

        def track(algo, i, max_iter):
            objectives.append(float(algo.log_evidence()))
            return False

        py = tt.ExpectationPropagation(student).iterate(
            max_iter=K, damping="adaptive", callback=track)
        check(py.n_iter == K and same_state(torch, py.state, ep.state),
              f"adaptive EP {dname}: the callback loop's state differs "
              "from the loop without callback's")
        scale = max(abs(a) for a in objectives)
        fall = max(0.0, max(a - b for a, b in zip(objectives[1:],
                                                   objectives[2:])))
        check(all(math.isfinite(a) for a in objectives)
              and fall <= OBJECTIVE_ROUNDING[dname] * scale,
              f"adaptive EP {dname}: objectives {objectives} fall by "
              f"{fall:.3g} (bound {OBJECTIVE_ROUNDING[dname]:g} of "
              f"{scale:.4g})")
        x = ep.get_variable_data("x")
        check(bool(torch.isfinite(x["r"]).all())
              and float(x["v"].double().mean()) > 0,
              f"adaptive EP {dname}: x posterior not finite")
        # one adaptive sweep from the run's state beside a plain one
        a_l, a_k, a_dev, a_wall, a_post = sweep_readings(
            torch, pl, lambda: ep.iterate(max_iter=1, damping="adaptive",
                                          warm_start=True, tol=0.0))
        check(a_l == {"pl_posterior": ADAPTIVE_PL_POSTERIOR,
                      "pl_forward_message": 1, "pl_backward_message": 1},
              f"adaptive EP {dname}: a warm sweep launched {a_l}")
        # the relu factor's log-partition runs the kernel on z and a
        n = ep.get_variable_data("z")["r"].numel()
        check(n == ep.get_variable_data("a")["r"].numel(),
              f"adaptive EP {dname}: z and a differ in size")
        p_l, p_k, p_dev, p_wall, _ = sweep_readings(
            torch, pl, lambda: ep.iterate(max_iter=1, damping=0.1,
                                          warm_start=True, tol=0.0))
        readings[dname] = dict(
            n=n, launches_per_sweep=a_l["pl_posterior"],
            kernels=a_k, device_ms=a_dev, wall_ms=a_wall,
            pl_posterior_device_ms=a_post, plain_kernels=p_k,
            plain_device_ms=p_dev, plain_wall_ms=p_wall)
        print(f"phase 14a adaptive EP relu net N={students[dname][2].Nz} "
              f"{dname}: {K} sweeps "
              f"in {wall:.3f} s, launches {launches}; objectives from "
              f"{objectives[0]:.8g} to {objectives[-1]:.8g}, largest fall "
              f"after the first sweep {fall:.3g} ({fall / scale:.3g} of "
              f"the largest |A|); both loops one state. One warm sweep "
              f"under torch.profiler: adaptive {a_k:.1f} kernels, device "
              f"{a_dev:.4f} ms (pl_posterior {a_post:.4f} ms in "
              f"{a_l['pl_posterior']} launches of n={n}) of {a_wall:.4f} "
              f"ms, busy "
              f"{100 * a_dev / a_wall:.2f}%; damping=0.1 {p_k:.1f} kernels, "
              f"device {p_dev:.4f} ms of {p_wall:.4f} ms, busy "
              f"{100 * p_dev / p_wall:.2f}%; adaptive/plain wall "
              f"{a_wall / p_wall:.2f}x [{card}]")
    # card against CPU, float64, accept decisions compared
    Recording = recording_engine(tt)
    cpu_student, _, cpu_linear = relu_net(torch, tt, torch.float64,
                                          N=EXTRAS_N, device="cpu")
    svd = (cpu_linear.U, cpu_linear.s, cpu_linear.V.T)
    gpu_student = relu_net(torch, tt, torch.float64, N=EXTRAS_N, svd=svd)[0]
    runs = [Recording(m).iterate(max_iter=K, damping="adaptive", tol=0.0)
            for m in (cpu_student, gpu_student)]
    choices = [accept_choices(torch, run) for run in runs]
    check(choices[0].shape == choices[1].shape
          and choices[0].numel() == 12 * (K - 1),
          f"adaptive EP N={EXTRAS_N}: {choices[0].numel()} and "
          f"{choices[1].numel()} scored writes")
    flips = int((choices[0] != choices[1]).sum())
    kept = int((choices[0] >= 0).sum())
    card_against_cpu(
        torch, f"phase 14a adaptive EP relu net N={EXTRAS_N} f64 ({flips} "
        f"of {choices[0].numel()} accept decisions differ; {kept} writes "
        "took a candidate on the CPU)",
        {"x": runs[0].get_variable_data("x")}, K,
        {"x": runs[1].get_variable_data("x")}, runs[1].n_iter, ("x",),
        rtol=1e-8 if flips == 0 else FLIP_RTOL)
    return paths, readings, (cpu_student, gpu_student)


def counting_se(tt):
    """The SE engine, counting the node objectives it scores by node type
    and its calls of ``_prepare`` (the model's second moments), with their
    host time."""
    class Counting(tt.StateEvolution):
        def __init__(self, model):
            super().__init__(model)
            self.reset()

        def reset(self):
            self.objectives, self.prepares, self.prepare_s = {}, 0, 0.0

        def node_objective_at(self, i, state, aux=None):
            kind = type(self.nodes[i]).__name__
            self.objectives[kind] = self.objectives.get(kind, 0) + 1
            return super().node_objective_at(i, state, aux)

        def _prepare(self, model):
            t0 = time.perf_counter()
            aux = super()._prepare(model)
            self.prepares += 1
            self.prepare_s += time.perf_counter() - t0
            return aux

    return Counting


def phase_14b_adaptive_se(torch, tt, pl, students, card):
    """Adaptive SE of the relu-net student, float64, card against CPU, and
    where one warm adaptive sweep's time goes."""
    student, _, linear = students["float64"]
    svd = tuple(t.cpu() for t in (linear.U, linear.s, linear.V.T))
    cpu_student, _, _ = relu_net(torch, tt, torch.float64, device="cpu",
                                 svd=svd, N=linear.W.shape[1])
    tt.StateEvolution(student).iterate(max_iter=3, damping="adaptive")
    torch.cuda.synchronize()
    reset_launches(pl)
    t0 = time.perf_counter()
    se = tt.StateEvolution(student).iterate(max_iter=200, damping="adaptive")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    # 2 SE integrands per sweep, and from the second sweep on the 22
    # objectives of the two writes into the relu factor
    want = 2 * se.n_iter + ADAPTIVE_PL_POSTERIOR * (se.n_iter - 1)
    check(launches == {"pl_posterior": want, "pl_forward_message": 0,
                       "pl_backward_message": 0} and se.n_iter > 1,
          f"adaptive SE: launches {launches} for {se.n_iter} sweeps "
          f"(want {want} of pl_posterior)")
    cpu_se = tt.StateEvolution(cpu_student).iterate(max_iter=200,
                                                    damping="adaptive")
    ids = ("x", "z", "a")
    v, v_cpu = se_v(se, ids), se_v(cpu_se, ids)
    err = worst_of(abs(v[id] - v_cpu[id]) / v_cpu[id] for id in ids)
    check(se.n_iter == cpu_se.n_iter and err <= 1e-8,
          f"adaptive SE: card n_iter {se.n_iter} vs CPU {cpu_se.n_iter}, v "
          f"rel err {err:.3g} (rtol 1e-8)")
    print(f"phase 14b adaptive SE of the relu-net student f64: n_iter "
          f"{se.n_iter} on the card and the CPU, v rel err {err:.3e} (rtol "
          f"1e-8), v " + ", ".join(f"{id} {v[id]:.8g}" for id in ids)
          + f"; {launches['pl_posterior']} pl_posterior launches "
          f"({launches['pl_posterior'] / se.n_iter:.2f} per sweep), "
          f"{wall:.3f} s on the card alone [{card}]")
    # one warm adaptive sweep: what it scores, and where its time goes
    counting = counting_se(tt)(student)
    counting.iterate(max_iter=2, damping="adaptive", tol=0.0)
    torch.cuda.synchronize()
    counting.reset()
    t0 = time.perf_counter()
    counting.iterate(max_iter=1, damping="adaptive", warm_start=True,
                     tol=0.0)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    scored = dict(counting.objectives)
    check(sum(scored.values()) == 12 * (1 + 10),
          f"adaptive SE: one sweep scored {scored}, want 12 x 11")
    prepares, prepare_s = counting.prepares, counting.prepare_s
    s_l, s_k, s_dev, s_wall, s_post = sweep_readings(
        torch, pl, lambda: counting.iterate(
            max_iter=1, damping="adaptive", warm_start=True, tol=0.0),
        reps=1)
    check(s_l == {"pl_posterior": 2 + ADAPTIVE_PL_POSTERIOR,
                  "pl_forward_message": 0, "pl_backward_message": 0},
          f"adaptive SE: a warm sweep launched {s_l}")
    print(f"phase 14b one warm adaptive SE sweep: {1e3 * sweep_wall:.4f} ms "
          f"wall; objectives scored by node type {scored}; {prepares} calls "
          f"of _prepare (the model's second moments), {1e3 * prepare_s:.4f} "
          f"ms of host time ({100 * prepare_s / sweep_wall:.2f}%); under "
          f"torch.profiler {s_k:.1f} kernels, device {s_dev:.4f} ms "
          f"(pl_posterior {s_post:.4f} ms in {s_l['pl_posterior']} "
          f"launches) of {s_wall:.4f} ms, busy {100 * s_dev / s_wall:.2f}% "
          f"[{card}]")
    return launches


def phase_14c_update_dA(torch, tt, pl, students, pair, card):
    "update_dA on the relu net: every slot, finite, the CPU's at N = 256."
    K = 5
    student = students["float32"][0]
    reset_launches(pl)
    ep = tt.ExpectationPropagation(student).iterate(
        max_iter=K, damping=0.1, update_dA=True)
    torch.cuda.synchronize()
    launches = read_launches(pl)
    want = {"pl_posterior": DA_PL_POSTERIOR * K, "pl_forward_message": K,
            "pl_backward_message": K}
    check(ep.n_iter == K and set(ep.dA) == set(range(ep.n_slots))
          and all(math.isfinite(v) for v in ep.dA.values())
          and launches == want,
          f"update_dA N=4096 f32: {ep.n_iter} sweeps, slots "
          f"{sorted(ep.dA)}, launches {launches} (want {want}), dA {ep.dA}")
    engines = [tt.ExpectationPropagation(m).iterate(
        max_iter=K, damping=0.1, update_dA=True) for m in pair]
    dA = [np.array([e.dA[s] for s in range(e.n_slots)]) for e in engines]
    scale = float(np.abs(dA[0]).max())
    err = float(np.max(np.abs(dA[1] - dA[0])
                       / (np.abs(dA[0]) + scale)))
    check(np.isfinite(dA[1]).all() and err <= 1e-8,
          f"update_dA N={EXTRAS_N} f64: card against CPU {err:.3g} (rtol "
          "1e-8 of each |dA| plus the largest)")
    print(f"phase 14c update_dA: N=4096 f32 {K} sweeps, dA of all "
          f"{ep.n_slots} slots finite (largest |dA| "
          f"{max(abs(v) for v in ep.dA.values()):.4g}), launches {launches};"
          f" N={EXTRAS_N} f64 card against CPU: worst {err:.3e} (rtol 1e-8"
          f" of |dA| plus the largest, {scale:.4g}) [{card}]")
    return launches


def host_reads(torch, fn):
    """(fn(), the synchronizing CUDA calls it made as "file:line" of the
    Python line that made each), from torch's sync debug mode."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def phase_14d_run_trace(torch, tt, pl, students, card):
    """run_trace against a TrackEvolution callback, its host reads, its
    launches and wall time per sweep beside the plain loop's."""
    from tramp_tpu_torch.algos import TrackEvolution
    paths = {}
    n = TRACE_SWEEPS
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        student = students[dname][0]
        tt.ExpectationPropagation(student).run_trace(n_iter=3, damping=0.1)
        torch.cuda.synchronize()
        ep = tt.ExpectationPropagation(student)
        ep.state = ep.init_state()
        reset_launches(pl)
        t0 = time.perf_counter()
        trace, reads = host_reads(
            torch, lambda: ep.run_trace(n_iter=n, damping=0.1,
                                        warm_start=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = paths[f"run_trace_relu_net_{dname}"] = read_launches(pl)
        check(launches == {"pl_posterior": 0, "pl_forward_message": n,
                           "pl_backward_message": n} and len(reads) == 1
              and ep.n_iter == n,
              f"run_trace {dname}: launches {launches}, {len(reads)} host "
              f"reads (want 1) at {reads}, n_iter {ep.n_iter}")
        track = TrackEvolution()
        tt.ExpectationPropagation(student).iterate(
            max_iter=n, damping=0.1, callback=track)
        worst = 0.0
        for id, curve in trace.items():
            want = np.array([r["v"] for r in track.records if r["id"] == id])
            got = curve.double().numpy()
            check(got.shape == want.shape == (n,),
                  f"run_trace {dname}: {id} has {got.shape}, the callback "
                  f"{want.shape}")
            worst = max(worst, float(np.max(np.abs(got - want)
                                            / np.abs(want))))
        check(worst <= TRACE_RTOL[dname],
              f"run_trace {dname}: {worst:.3g} off the callback's curve "
              f"(rtol {TRACE_RTOL[dname]:g})")
        plain = tt.ExpectationPropagation(student)
        plain.iterate(max_iter=3, damping=0.1, tol=0.0)
        plain.state = plain.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.iterate(max_iter=n, damping=0.1, tol=0.0, warm_start=True)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        print(f"phase 14d run_trace relu net N={students[dname][2].Nz} "
              f"{dname}: {n} sweeps, "
              f"{len(reads)} host read, launches {launches}, "
              f"{1e3 * wall / n:.4f} ms per sweep against "
              f"{1e3 * plain_wall / n:.4f} ms for iterate(tol=0) "
              f"({wall / plain_wall:.3f}x); v curves within {worst:.3e} of "
              f"TrackEvolution's (rtol {TRACE_RTOL[dname]:g}) [{card}]")
    return paths


def phase_14e_checkpoints(torch, tt, pl, students, pair, card):
    """save_state / load_state (on the card; a CPU checkpoint resumed on
    the card) and save_checkpoint / restore_checkpoint around the batched
    solvers at LANES lanes."""
    import os
    from tramp_tpu_torch.parallel import (
        EPSolver, MLVAMPSolver, restore_checkpoint, save_checkpoint,
        with_buffers)
    where = extras_dir()
    paths = {}
    student, _, linear = students["float32"]
    path = os.path.join(where, "relu_net.npz")
    reset_launches(pl)
    full = tt.ExpectationPropagation(student).iterate(max_iter=10,
                                                      damping=0.1, tol=0.0)
    full.save_state(path)
    full.iterate(max_iter=10, damping=0.1, tol=0.0, warm_start=True)
    resumed = tt.ExpectationPropagation(student).load_state(path)
    resumed.iterate(max_iter=10, damping=0.1, tol=0.0, warm_start=True)
    torch.cuda.synchronize()
    paths["checkpoint_resume_relu_net_float32"] = read_launches(pl)
    check(resumed.n_iter == full.n_iter == 20
          and same_state(torch, resumed.state, full.state),
          "save_state / load_state / resume differs from the run that was "
          "not interrupted")
    print("phase 14e save_state / load_state N=4096 f32: 10 + 10 sweeps "
          "bit-identical to 20; launches "
          + str(paths["checkpoint_resume_relu_net_float32"]))
    cpu_student, gpu_student = pair
    cpu_path = os.path.join(where, "cpu.npz")
    cpu_ep = tt.ExpectationPropagation(cpu_student).iterate(
        max_iter=5, damping=0.1, tol=0.0)
    cpu_ep.save_state(cpu_path)
    gpu_ep = tt.ExpectationPropagation(gpu_student).load_state(cpu_path)
    check(all(v.device.type == "cuda" for m in gpu_ep.state
              for v in m.values()), "a CPU checkpoint did not load onto "
                                    "the card")
    for ep in (cpu_ep, gpu_ep):
        ep.iterate(max_iter=10, damping=0.1, tol=0.0, warm_start=True)
    card_against_cpu(torch, f"phase 14e CPU checkpoint (N={EXTRAS_N} f64) "
                     "resumed on the card",
                     {"x": cpu_ep.get_variable_data("x")}, cpu_ep.n_iter,
                     {"x": gpu_ep.get_variable_data("x")}, gpu_ep.n_iter,
                     ("x",))
    likelihood = len(student.factors) - 1
    _, ys = batch_of_observations(torch, linear.W, LANES, True, seed=7)
    stacked = with_buffers(student, {(likelihood, "y"): ys})
    for cls, kw in ((MLVAMPSolver, {}),
                    (EPSolver, dict(rollback_increase=float("inf")))):
        kw = dict(kw, damping=0.1, tol=BATCH_TOL)
        name = cls.__name__
        reset_launches(pl)
        t0 = time.perf_counter()
        post, n_full = cls(student, max_iter=500, **kw).solve_batch(stacked)
        _, state, n_first = cls(student, max_iter=BATCH_SPLIT,
                                **kw).solve_batch_with_state(stacked)
        ckpt = save_checkpoint(os.path.join(where, name), state, n_first)
        state_r, n_r = restore_checkpoint(ckpt, like=(state, n_first))
        post_r, n_rest = cls(student, max_iter=500 - BATCH_SPLIT,
                             **kw).solve_batch(stacked, state=state_r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[f"checkpoint_batch_{name}"] = read_launches(pl)
        check(n_first.tolist() == [BATCH_SPLIT] * LANES
              and torch.equal(n_r, n_first)
              and torch.equal(n_rest + BATCH_SPLIT, n_full),
              f"{name} checkpoint at {LANES} lanes: n_iter of the halves "
              f"({int(n_first.max())}, {int(n_rest.max())}) against "
              f"{int(n_full.max())}")
        for vid in post:
            for key in ("r", "v"):
                check(torch.equal(post_r[vid][key], post[vid][key]),
                      f"{name} checkpoint at {LANES} lanes: {key} of {vid} "
                      "differs from the run that was not interrupted")
        print(f"phase 14e {name} relu net f32, {LANES} lanes: "
              f"{BATCH_SPLIT} iterations, save_checkpoint, "
              f"restore_checkpoint, resume: r, v and n_iter (up to "
              f"{int(n_full.max())}) equal to the solve that was not "
              f"interrupted, {wall:.3f} s for both [{card}]")
    return paths


def phase_14f_checks(torch, tt, card):
    "The gradient checks on the card in float64 against the CPU."
    from tramp_tpu_torch import beliefs, checks
    from tramp_tpu_torch.likelihoods import SgnLikelihood
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    calls = {
        "check_prior_grad_EP": lambda d: checks.check_prior_grad_EP(
            GaussBernoulliPrior(size=1, rho=0.4, device=d,
                                dtype=torch.float64)),
        "check_likelihood_grad_EP": lambda d: checks.check_likelihood_grad_EP(
            SgnLikelihood(y=None), y=1.0, device=d),
        "check_belief_grad_b": lambda d: checks.check_belief_grad_b(
            beliefs.sparse, a=1.3, eta=0.4, device=d)}
    t0 = time.perf_counter()
    for name, call in calls.items():
        gpu, cpu = call("cuda"), call("cpu")
        worst = 0.0
        for col in cpu.columns:
            if col.endswith("err"):
                continue
            want, got = cpu[col].to_numpy(), gpu[col].to_numpy()
            scale = float(np.abs(want).max())
            worst = max(worst, float(np.max(np.abs(got - want)
                                            / (np.abs(want) + scale))))
        check(worst <= 1e-10 and len(gpu) == len(cpu),
              f"{name} on the card against the CPU: {worst:.3g} (rtol "
              "1e-10)")
        print(f"phase 14f {name} float64 on the card: {len(gpu)} rows, "
              f"worst {worst:.3e} against the CPU (rtol 1e-10), largest "
              + ", ".join(f"{c} {gpu[c].max():.3g}" for c in gpu.columns
                          if c.endswith("err")) + f" [{card}]")
    return time.perf_counter() - t0


def phase_14g_explain(torch, tt, pl):
    "One explained sweep of a small relu net on the card."
    import contextlib
    import io
    from tramp_tpu_torch.algos import ExplainMessagePassing
    lines = {}
    cpu_student, _, linear = relu_net(torch, tt, torch.float64, N=64,
                                      device="cpu")
    svd = (linear.U, linear.s, linear.V.T)
    gpu_student = relu_net(torch, tt, torch.float64, N=64, svd=svd)[0]
    for where, student in (("card", gpu_student), ("host", cpu_student)):
        out = io.StringIO()
        reset_launches(pl)
        with contextlib.redirect_stdout(out):
            ExplainMessagePassing(student).iterate(max_iter=1)
        lines[where] = out.getvalue().splitlines()
        if where == "card":
            launches = read_launches(pl)
    check(lines["card"] == lines["host"] and len(lines["card"]) > 4,
          "ExplainMessagePassing prints other lines on the card than on the "
          "CPU")
    check(launches == {"pl_posterior": 0, "pl_forward_message": 1,
                       "pl_backward_message": 1},
          f"ExplainMessagePassing: launches {launches}")
    print(f"phase 14g ExplainMessagePassing, one sweep of the relu net N=64 "
          f"on the card ({len(lines['card'])} lines, the CPU's; the first "
          "20):")
    for line in lines["card"][:20]:
        print("    " + line[:160])
    return launches


def phase_14(torch, tt, pl, students, card):
    """Phase 14: the engine extras and the tooling. Returns (launches by
    path, each path's counts set to 0 just before it and read just after;
    the adaptive sweep's readings)."""
    t0 = time.perf_counter()
    seconds = {}

    def lap(part):
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    paths, readings, pair = phase_14a_adaptive_ep(torch, tt, pl, students,
                                                  card)
    lap("a")
    paths["adaptive_se_relu_net"] = phase_14b_adaptive_se(
        torch, tt, pl, students, card)
    lap("b")
    paths["update_dA_relu_net_float32"] = phase_14c_update_dA(
        torch, tt, pl, students, pair, card)
    lap("c")
    paths.update(phase_14d_run_trace(torch, tt, pl, students, card))
    lap("d")
    paths.update(phase_14e_checkpoints(torch, tt, pl, students, pair, card))
    lap("e")
    phase_14f_checks(torch, tt, card)
    lap("f")
    paths["explain_relu_net"] = phase_14g_explain(torch, tt, pl)
    lap("g")
    print(f"phase 14: {time.perf_counter() - t0:.1f} s, by part "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" [{card}]")
    return paths, readings


# ---------------------------------------------------------------- phase 15
MESH_SOLVERS = {"EPSolver": (1e-6, 1e-8),        # tests/test_parallel.py:58-60
                "MLVAMPSolver": (1e-10, 1e-13)}  # tests/test_vamp_glm.py:120-125
GLOO_NET = dict(N=256, lanes=8, seed=5)  # 15e's relu net, float64, CPU
GLOO_MESHES = [(2, 1), (1, 2)]
COLLECTIVE_CALLS = 200


def mesh_dir():
    "A scratch directory of phase 15 inside the checkout (git-ignored)."
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "phase15")
    os.makedirs(path, exist_ok=True)
    return path


def same_bits(torch, what, got, want):
    "Every lane's r, v and n_iter of ``got`` are those of ``want``."
    (post, n_iter), (post_w, n_w) = got, want
    check(torch.equal(n_iter, n_w), f"{what}: n_iter differs from the "
                                    "unsharded solve")
    for vid in post_w:
        for key in ("r", "v"):
            check(torch.equal(post[vid][key], post_w[vid][key]),
                  f"{what}: {key} of {vid} differs from the unsharded solve")


def timed_batch(torch, pl, run, reps=3):
    """A warm-up run of ``run()``, ``reps`` timed ones (the kernels' counts
    set to 0 just before the first and read just after it), and one under
    torch.profiler. Returns (the first timed run's result, the median wall
    seconds, its launches, device ms)."""
    run()
    walls = []
    for rep in range(reps):
        torch.cuda.synchronize()
        reset_launches(pl)
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if rep == 0:
            out, launches = result, read_launches(pl)
    _, device_ms, _ = profiled(run, 1)
    return out, float(np.median(walls)), launches, device_ms


def collective_costs(torch, mesh, card):
    """What the mesh's collectives cost on one nccl rank: the loop's stop
    test (one all_reduce(MIN) and the host read) beside the host read
    alone, and the gather of a (LANES, 4096) float32 posterior, per call."""
    from tramp_tpu_torch.parallel.mesh import MeshLanes, all_done
    where = MeshLanes(mesh, LANES)
    done = torch.ones(LANES, dtype=torch.bool, device="cuda")
    groups = where.stop_groups()
    read = host_ms(lambda: bool(done.all()), COLLECTIVE_CALLS)
    reduced = host_ms(lambda: all_done(done, groups), COLLECTIVE_CALLS)
    r = torch.ones((LANES, 4096), device="cuda")
    gather = per_call_ms(lambda: where.gather(r))
    copy = per_call_ms(lambda: r.clone())
    print(f"phase 15 collectives on one nccl rank: the stop test "
          f"{reduced:.4f} ms per call with its all_reduce(MIN), "
          f"{read:.4f} ms the host read alone; all_gather of a "
          f"({LANES}, 4096) float32 posterior {gather:.4f} ms per call, a "
          f"copy of it {copy:.4f} ms [{card}]")


def phase_15a_relu_net(torch, tt, pl, students, mesh, card):
    """The relu net at phase 7's width (LANES lanes on one W, float32, tol
    BATCH_TOL) on a one-rank mesh through three entry points, each against
    the same solver's unsharded solve_batch. Returns launches by path."""
    from tramp_tpu_torch.parallel import (
        EPSolver, MLVAMPSolver, dispatch_solver, shard_batched_model,
        solve_batch_shard_map, with_buffers)
    student, _, linear = students["float32"]
    likelihood = len(student.factors) - 1
    _, ys = batch_of_observations(torch, linear.W, LANES, True, seed=4)
    stacked = with_buffers(student, {(likelihood, "y"): ys})
    sharded = shard_batched_model(stacked, mesh)
    kw = dict(SOLVE, tol=BATCH_TOL)
    ep = EPSolver(student, **kw)
    ml = dispatch_solver(student, **kw)
    check(type(ml) is MLVAMPSolver,
          f"relu net: dispatch_solver gave {type(ml).__name__}")
    refs = {"EPSolver": timed_batch(torch, pl,
                                    lambda: ep.solve_batch(stacked)),
            "MLVAMPSolver": timed_batch(torch, pl,
                                        lambda: ml.solve_batch(stacked))}
    paths = {
        "EPSolver.solve_batch": (
            "EPSolver", lambda: ep.solve_batch(sharded)),
        "solve_batch_shard_map(EPSolver)": (
            "EPSolver",
            lambda: solve_batch_shard_map(ep, stacked, mesh)[:2]),
        "MLVAMPSolver.solve_batch": (
            "MLVAMPSolver", lambda: ml.solve_batch(sharded))}
    launches_by = {}
    for path, (name, run) in paths.items():
        what = f"phase 15a relu net f32, {LANES} lanes, {path}"
        got, wall, launches, device_ms = timed_batch(torch, pl, run)
        want, wall_w, _, device_w = refs[name]
        same_bits(torch, what, got, want)
        iterations = int(got[1].max())
        check(launches["pl_forward_message"] == iterations
              and launches["pl_backward_message"] == iterations
              and launches["pl_posterior"] == 0,
              f"{what}: launches {launches} for {iterations} iterations "
              "(want one of each message per iteration)")
        print(f"{what} on a one-rank nccl mesh (1, 1): the bits of the "
              f"unsharded solve (r, v, n_iter of every lane), {iterations} "
              f"iterations, {wall:.4f} s, {1e3 * wall / iterations:.4f} ms "
              f"per iteration, device {device_ms / iterations:.4f} ms per "
              f"iteration, busy {100 * device_ms / (1e3 * wall):.2f}%; "
              f"unsharded {wall_w:.4f} s, "
              f"{1e3 * wall_w / iterations:.4f} ms per iteration, busy "
              f"{100 * device_w / (1e3 * wall_w):.2f}%; launches {launches} "
              f"[{card}]")
        launches_by[f"mesh_relu_net_{path}"] = launches
    return launches_by


def phase_15b_flagship(torch, tt, pl, student, linear, mesh, card):
    """The flagship's LANES-lane batch of phase 6 through
    SpectralVAMPSolver.solve_batch on a one-rank mesh, against the
    unsharded solve; the operator bytes a rank holds. Returns launches."""
    from tramp_tpu_torch.parallel import (
        SpectralVAMPSolver, dispatch_solver, shard_batched_model,
        with_buffers)
    from tramp_tpu_torch.parallel.mesh import axis_size
    solver = dispatch_solver(student)
    check(type(solver) is SpectralVAMPSolver,
          f"flagship: dispatch_solver gave {type(solver).__name__}")
    _, ys = batch_of_observations(torch, linear.W, LANES, False, seed=3)
    stacked = with_buffers(student, {(2, "y"): ys})
    sharded = shard_batched_model(stacked, mesh)
    want, wall_w, _, device_w = timed_batch(
        torch, pl, lambda: solver.solve_batch(stacked))
    got, wall, launches, device_ms = timed_batch(
        torch, pl, lambda: solver.solve_batch(sharded))
    what = f"phase 15b flagship f32, {LANES} lanes, SpectralVAMPSolver"
    same_bits(torch, what, got, want)
    check(not any(launches.values()), f"{what} ran kernels: {launches}")
    fields = linear._model_split_fields
    whole = sum(linear._buffers[k].nbytes for k in fields)
    local = sum(sharded.factors[1]._buffers[k].nbytes for k in fields)
    P = axis_size(mesh, "model")
    check(whole == local * P, f"{what}: {local} operator bytes on the rank "
                              f"of {whole}")
    iterations = int(got[1].max())
    print(f"{what}.solve_batch on a one-rank nccl mesh (1, 1): the bits "
          f"of the unsharded solve, {iterations} iterations, {wall:.4f} s, "
          f"busy {100 * device_ms / (1e3 * wall):.2f}%; unsharded "
          f"{wall_w:.4f} s, busy {100 * device_w / (1e3 * wall_w):.2f}%; "
          f"operator bytes (W, U, V) on the rank {local} of {whole}, ratio "
          f"{whole / local:g} for a model axis of {P} [{card}]")
    return launches


def phase_15c_grid(torch, tt, pl, card):
    """Phase 9b's 1030-point grid through se_phase_grid_records on a
    one-rank (1,) data mesh, against the same call without one, and its
    CSV. Returns launches."""
    import os
    import pandas as pd
    from tramp_tpu_torch.parallel import (
        make_mesh, save_grid_csv, se_phase_grid_records)
    alphas, rhos, kw = cs_grid()
    n = len(alphas) * len(rhos)
    mesh = make_mesh((1,), ("data",))
    want = se_phase_grid_records(tt.glm_state_evolution, **kw)
    torch.cuda.synchronize()
    reset_launches(pl)
    t0 = time.perf_counter()
    got = se_phase_grid_records(tt.glm_state_evolution, mesh=mesh, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    check(len(got) == n and got == want,
          f"phase 15c: {sum(a != b for a, b in zip(got, want))} of "
          f"{len(got)} records differ from the grid without a mesh")
    check(not any(launches.values()), f"phase 15c ran kernels: {launches}")
    csv = os.path.join(mesh_dir(), "grid.csv")
    wrote = save_grid_csv(pd.DataFrame(got), csv)
    with open(csv) as f:
        lines = sum(1 for _ in f)
    check(wrote and lines == n + 1, f"phase 15c: save_grid_csv gave "
                                    f"{wrote}, {lines} lines")
    print(f"phase 15c SE grid of compressed sensing, {n} points on a "
          f"one-rank (1,) nccl data mesh: every record equal to the grid "
          f"without a mesh, {wall:.4f} s with building the models; "
          f"save_grid_csv wrote {lines} lines [{card}]")
    return launches


def phase_15d_checkpoints(torch, tt, pl, students, mesh, card):
    """The LANES-lane EPSolver batch (phase 14e's) on a one-rank mesh cut
    after BATCH_SPLIT iterations, its state saved from the rank's lanes,
    restored through a sharded template and resumed, against the uncut
    solve. Returns launches."""
    import os
    from tramp_tpu_torch.parallel import (
        EPSolver, restore_checkpoint, save_checkpoint, shard_batched_model,
        shard_batched_state, with_buffers)
    student, _, linear = students["float32"]
    likelihood = len(student.factors) - 1
    _, ys = batch_of_observations(torch, linear.W, LANES, True, seed=7)
    sharded = shard_batched_model(
        with_buffers(student, {(likelihood, "y"): ys}), mesh)
    kw = dict(damping=0.1, tol=BATCH_TOL, rollback_increase=float("inf"))
    reset_launches(pl)
    t0 = time.perf_counter()
    post, n_full = EPSolver(student, max_iter=500, **kw).solve_batch(sharded)
    _, state, n_first = EPSolver(student, max_iter=BATCH_SPLIT,
                                 **kw).solve_batch_with_state(sharded)
    parts = shard_batched_state(state, mesh)
    ckpt = save_checkpoint(os.path.join(mesh_dir(), "EPSolver"), parts,
                           n_first)
    state_r, n_r = restore_checkpoint(ckpt, like=(parts, n_first))
    post_r, n_rest = EPSolver(student, max_iter=500 - BATCH_SPLIT,
                              **kw).solve_batch(sharded, state=state_r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    what = f"phase 15d EPSolver checkpoint on a one-rank mesh, {LANES} lanes"
    check(n_first.tolist() == [BATCH_SPLIT] * LANES
          and torch.equal(n_r, n_first)
          and torch.equal(n_rest + BATCH_SPLIT, n_full),
          f"{what}: n_iter of the halves ({int(n_first.max())}, "
          f"{int(n_rest.max())}) against {int(n_full.max())}")
    same_bits(torch, what, (post_r, n_rest + BATCH_SPLIT), (post, n_full))
    sweeps = int(n_full.max()) + BATCH_SPLIT + int(n_rest.max())
    check(launches["pl_forward_message"] == sweeps
          and launches["pl_backward_message"] == sweeps,
          f"{what}: launches {launches} for {sweeps} iterations")
    print(f"{what}: {BATCH_SPLIT} iterations, save_checkpoint of the "
          f"rank's lanes, restore_checkpoint through a sharded template, "
          f"resume: r, v and n_iter (up to {int(n_full.max())}) equal to "
          f"the uncut solve, {wall:.3f} s for both, launches {launches} "
          f"[{card}]")
    return launches


def gloo_solves(torch, tt, mesh=None):
    """15e's relu net (N = 256, 8 lanes, float64, on the CPU) through
    EPSolver and MLVAMPSolver: {solver: (post, n_iter)}, sharded on
    ``mesh`` if one is given."""
    from tramp_tpu_torch.parallel import (
        EPSolver, dispatch_solver, shard_batched_model, with_buffers)
    student, _, linear = relu_net(torch, tt, torch.float64,
                                  N=GLOO_NET["N"], device="cpu")
    _, ys = batch_of_observations(torch, linear.W, GLOO_NET["lanes"], True,
                                  seed=GLOO_NET["seed"])
    stacked = with_buffers(student, {(len(student.factors) - 1, "y"): ys})
    if mesh is not None:
        stacked = shard_batched_model(stacked, mesh)
    return {"EPSolver": EPSolver(student, **SOLVE).solve_batch(stacked),
            "MLVAMPSolver": dispatch_solver(student, **SOLVE).solve_batch(
                stacked)}


def gloo_worker(argv):
    """One rank of 15e's gloo world on the CPU: the solves of gloo_solves
    on each mesh of GLOO_MESHES, saved to <dir>/rank<r>.npz."""
    import os
    import torch
    import torch.distributed as dist
    import tramp_tpu_torch as tt
    from tramp_tpu_torch.parallel import make_mesh
    rank, world, port, where = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    out = {}
    for shape in GLOO_MESHES:
        mesh = make_mesh(shape, device="cpu")
        for name, (post, n_iter) in gloo_solves(torch, tt, mesh).items():
            key = f"{shape[0]}x{shape[1]}/{name}"
            out[f"{key}/n_iter"] = n_iter.numpy()
            for vid, d in post.items():
                for k in ("r", "v"):
                    out[f"{key}/{vid}/{k}"] = d[k].numpy()
    np.savez(os.path.join(where, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def nccl_worker(argv):
    "One rank of 15e's two nccl ranks on the one card: an all_reduce."
    import torch
    import torch.distributed as dist
    rank, world, port = int(argv[0]), int(argv[1]), argv[2]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    t = torch.ones(1, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(f"rank {rank}: all_reduce gave {float(t)}")
    dist.destroy_process_group()


def spawn_world(flag, world, extra, env, timeout):
    """Start ``world`` processes of this script in worker mode ``flag`` and
    wait for them; every process is killed at the time limit. Returns
    [(exit code or None if killed, the last line of stderr that names an
    error and the line after it, else its last line, stdout)]."""
    import os
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(rank),
         str(world), str(port)] + extra, cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + timeout
    results = []
    for p in procs:
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            code = p.returncode
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            code = None
        lines = [line for line in err.splitlines() if line.strip()] or [""]
        last = max((i for i, line in enumerate(lines) if "rror" in line),
                   default=len(lines) - 1)
        results.append((code, " ".join(lines[last:last + 2]), out.strip()))
    return results


def phase_15e_several_ranks(torch, tt, card):
    """Two nccl ranks on the one card (NCCL refuses a duplicate GPU: what
    it prints is a reading), then a gloo world of 2 on the CPU: the relu
    net (N = 256, 8 lanes, float64) on (2, 1) and (1, 2) meshes against
    the same solves in this process, on the CPU."""
    import os
    env = dict(os.environ)
    t0 = time.perf_counter()
    ranks = spawn_world("--nccl-rank", 2, [], env, timeout=30)
    wall = time.perf_counter() - t0
    for rank, (code, err, out) in enumerate(ranks):
        print(f"phase 15e two nccl ranks on one card, rank {rank}: exit "
              f"{'killed at 30 s' if code is None else code} after "
              f"{wall:.1f} s; {out or err}")
    where = mesh_dir()
    env["CUDA_VISIBLE_DEVICES"] = ""
    t0 = time.perf_counter()
    ranks = spawn_world("--gloo-rank", 2, [where], env, timeout=240)
    for rank, (code, err, _) in enumerate(ranks):
        check(code == 0, f"phase 15e gloo rank {rank} (CPU): exit {code}: "
                         f"{err}")
    wall = time.perf_counter() - t0
    got = []
    for rank in range(2):
        with np.load(os.path.join(where, f"rank{rank}.npz")) as f:
            got.append({k: f[k] for k in f.files})
    # the ranks run one thread each, and a CPU GEMM's order of summation
    # can depend on its threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = gloo_solves(torch, tt)
    finally:
        torch.set_num_threads(threads)
    for shape in GLOO_MESHES:
        for name, (post, n_iter) in want.items():
            key = f"{shape[0]}x{shape[1]}/{name}"
            rtol, atol = MESH_SOLVERS[name] if shape[1] > 1 else (0, 0)
            worst = 0.0
            for res in got:
                exact = shape[1] == 1 or name == "MLVAMPSolver"
                check(not exact or np.array_equal(res[f"{key}/n_iter"],
                                                  n_iter.numpy()),
                      f"phase 15e (CPU) {key}: n_iter differs")
                for vid, d in post.items():
                    for k in ("r", "v"):
                        a, b = res[f"{key}/{vid}/{k}"], d[k].numpy()
                        ok = np.allclose(a, b, rtol=rtol, atol=atol)
                        check(ok, f"phase 15e (CPU) {key}: {k} of {vid} "
                                  f"off the one-process solve (rtol {rtol}, "
                                  f"atol {atol})")
                        worst = max(worst, float(np.max(np.abs(a - b))))
            print(f"phase 15e (CPU, gloo, 2 ranks) relu net N="
                  f"{GLOO_NET['N']} f64, {GLOO_NET['lanes']} lanes, {name} "
                  f"on a {shape} mesh against one process: "
                  + ("the same bits" if shape[1] == 1 else
                     f"largest |difference| {worst:.3e} (rtol {rtol}, atol "
                     f"{atol})") + f", n_iter {n_iter.tolist()}")
    print(f"phase 15e (CPU): the gloo world of 2 took {wall:.1f} s")


def phase_15(torch, tt, pl, students, flagship, card):
    """Phase 15: the mesh, on a world of one nccl rank on the card (and a
    gloo world of 2 on the CPU). Returns launches by path, each path's
    counts set to 0 just before it and read just after."""
    import torch.distributed as dist
    from tramp_tpu_torch.parallel import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1))
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"phase 15: a {dist.get_backend()} world of "
          f"{dist.get_world_size()}")
    collective_costs(torch, mesh, card)
    paths = phase_15a_relu_net(torch, tt, pl, students, mesh, card)
    paths["mesh_flagship"] = phase_15b_flagship(torch, tt, pl, *flagship,
                                                mesh, card)
    paths["mesh_se_cs_grid"] = phase_15c_grid(torch, tt, pl, card)
    paths["mesh_checkpoint_EPSolver"] = phase_15d_checkpoints(
        torch, tt, pl, students, mesh, card)
    dist.destroy_process_group()
    t1 = time.perf_counter()
    phase_15e_several_ranks(torch, tt, card)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s, of which a-d "
          f"{t1 - t0:.1f} s [{card}]")
    return paths


# -- phase 16: the reduced-precision throughput mode -----------------------
GATED_SOLVE = dict(damping=0.1, max_iter=300, tol=1e-6,   # bench.py:356-357
                   stop_kind="v")
GATED_V_REL = 1e-3     # tests/test_parallel.py:305
MM_TOL = 1e-4          # |bf16 product - plain form| per |A_bf16| @ |x_bf16|
MM_PER_LANE = 4        # lanes of the one-operator-per-lane case
MM_K = 2               # the trailing K axis of the (n, K) layouts
BF16_PEAK_OPS_PER_S = 989e12
PINNED_FLAGSHIP = ({7: 4}, {5: (7,)})   # the JAX package's pinned slots
PIN_RTOL, PIN_ATOL = 1e-4, 1e-9         # tests/test_state_bf16.py:102
PIN_SOLVE = dict(SOLVE, tol=1e-10)      # both float64 solves at the point


def switched(name, value, run):
    """``run()`` with ``tramp_tpu_torch.config.<name>`` set to ``value``,
    and set back after."""
    from tramp_tpu_torch import config
    prev = getattr(config, name)
    setattr(config, name, value)
    try:
        return run()
    finally:
        setattr(config, name, prev)


def product_bound_ms(A, x, lanes, transpose):
    """(bound ms, "bytes" or "operations") of one bfloat16 product: the
    operator's bfloat16 copy and x (float32) read once, the float32 result
    written once; 2 operations per multiply-add at the bf16 tensor peak."""
    rows, cols = A.shape[-2:]
    inner = rows if transpose else cols
    out_per_column = cols if transpose else rows
    columns = x.numel() // inner
    moved = A.numel() * 2 + x.numel() * 4 + columns * out_per_column * 4
    by_bytes = moved / HBM_BYTES_PER_S
    by_ops = 2 * columns * inner * out_per_column / BF16_PEAK_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def phase_16a_products(torch, linear, card):
    """``LinearChannel._mm`` with MATVEC_BF16 on the card, every layout at
    the flagship's V (10^4 x 5000), against its plain form (operands
    rounded to bfloat16, widened to float32, a float32 product): each
    element within MM_TOL of |A_bf16| @ |x_bf16|, a float32 result. Times
    per call, bf16 and the exact float32 product in turns, beside the
    bf16 product's bound."""
    from tramp_tpu_torch.channels import LinearChannel
    g = torch.Generator(device="cuda").manual_seed(16)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    V = linear.V
    Nz, k = V.shape
    per_lane = torch.stack([V] + [randn(Nz, k) / math.sqrt(Nz)
                                  for _ in range(MM_PER_LANE - 1)])
    cases = []
    for A, lane_shapes in ((V, [(), (MM_K,), ("B",), ("B", MM_K)]),
                           (per_lane, [("P",), ("P", MM_K)])):
        for transpose in (False, True):
            n = Nz if transpose else k
            for shape in lane_shapes:
                lanes = bool(shape) and shape[0] in ("B", "P")
                head = ({"B": (LANES,), "P": (MM_PER_LANE,)}[shape[0]]
                        if lanes else ())
                tail = tuple(d for d in shape if d not in ("B", "P"))
                cases.append((A, randn(*(head + (n,) + tail)), lanes,
                              transpose))
    worst = 0.0
    for A, x, lanes, transpose in cases:
        kw = dict(lanes=lanes, transpose=transpose)
        got = LinearChannel._mm(A, x, bf16=True, **kw)
        A_b, x_b = A.bfloat16().float(), x.bfloat16().float()
        plain = LinearChannel._mm(A_b, x_b, bf16=False, **kw)
        bound = LinearChannel._mm(A_b.abs(), x_b.abs(), bf16=False, **kw)
        err = float(((got - plain).abs() / bound).max())
        what = (f"phase 16a bf16 product A {tuple(A.shape)}"
                f"{'^T' if transpose else ''} x {tuple(x.shape)}")
        check(got.dtype == torch.float32 and got.shape == plain.shape
              and bool(torch.isfinite(got).all()) and err <= MM_TOL,
              f"{what}: {got.dtype}, {tuple(got.shape)}, error {err:.3g} "
              f"of |A| @ |x| (bound {MM_TOL})")
        worst = max(worst, err)
        # a float32 product of (B, n, K) takes over 100 ms: fewer calls
        slow = per_call_ms(lambda: LinearChannel._mm(A, x, bf16=False, **kw),
                           calls=1, reps=1) > 5.0
        calls = dict(calls=2 if slow else 10, reps=3)
        times = []
        for bf16 in (False, True, True, False):
            times.append(per_call_ms(lambda: LinearChannel._mm(
                A, x, bf16=bf16, **kw), **calls))
        bf16_ms = min(times[1:3])
        f32_ms = min(times[0], times[3])
        bound_ms_, by = product_bound_ms(A, x, lanes, transpose)
        print(f"{what}: within {err:.3e} of |A| @ |x| (bound {MM_TOL}), "
              f"float32 out; per call bf16 {times[1]:.4f} / {times[2]:.4f} "
              f"ms, float32 {times[0]:.4f} / {times[3]:.4f} ms (in turns), "
              f"bound {bound_ms_:.4f} ms by {by}, bf16 at "
              f"{100 * bound_ms_ / bf16_ms:.1f}% of it, float32 / bf16 "
              f"{f32_ms / bf16_ms:.2f}x [{card}]")
    return worst


def solve_readings(torch, pl, run, lanes, peak=True):
    """One timed run of ``run()`` (a batched solver's ``_solve_batch``),
    the kernels' counts set to 0 just before and read just after: (post,
    n_iter, conv, wall s, peak bytes, launches)."""
    torch.cuda.synchronize()
    if peak:
        torch.cuda.reset_peak_memory_stats()
    reset_launches(pl)
    t0 = time.perf_counter()
    post, _, n_iter, conv = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    check(n_iter.shape == (lanes,) and all(
        bool(torch.isfinite(d["r"]).all()) for d in post.values()),
        "a batched solve's results are not finite or have no lanes")
    return post, n_iter, conv, wall, torch.cuda.max_memory_allocated(), \
        launches


def phase_16b_flagship(torch, tt, pl, student, linear, card):
    """The flagship's LANES lanes through SpectralVAMPSolver.solve_batch and
    EPSolver(stop_kind="v").solve_batch, MATVEC_BF16 off and on, in turns
    (off, on, on, off) in this process. Returns (the stacked model, the
    lanes' x, EP's f32 run)."""
    from tramp_tpu_torch.parallel import (
        EPSolver, SpectralVAMPSolver, with_buffers)
    x, ys = batch_of_observations(torch, linear.W, LANES, False, seed=16)
    stacked = with_buffers(student, {(2, "y"): ys})
    solvers = {"SpectralVAMPSolver": (SpectralVAMPSolver, {}),
               'EPSolver(stop_kind="v")': (EPSolver, GATED_SOLVE)}
    ep_f32 = None
    for name, (cls, kw) in solvers.items():
        solver = cls(student, **kw)
        windows, runs = {}, {False: [], True: []}
        for on in (False, True):
            windows[on] = switched("MATVEC_BF16", on, lambda: loop_window(
                lambda k: cls(student, **dict(kw, max_iter=k, tol=0.0))
                ._solve_batch(stacked)))
            switched("MATVEC_BF16", on, lambda: solver._solve_batch(stacked))
        for on in (False, True, True, False):
            runs[on].append(switched("MATVEC_BF16", on, lambda: solve_readings(
                torch, pl, lambda: solver._solve_batch(stacked), LANES)))
        v = {}
        for on in (False, True):
            post, n_iter, conv, wall, peak, launches = runs[on][0]
            check(not any(launches.values()), f"{name}: kernels {launches}")
            its = int(n_iter.max())
            dev = windows[on]["device_ms"]
            walls = [r[3] for r in runs[on]]
            v[on] = post["x"]["v"].double()
            # the band over the batch: one lane's MSE at N = 10^4 scatters
            # by several percent about its v, so the worst of LANES lanes
            # is a reading
            mse = ((post["x"]["r"].double() - x.double()) ** 2).mean(-1)
            band = float((mse.mean() - v[on].mean()).abs() / v[on].mean())
            lanes_band = (mse - v[on]).abs() / v[on]
            check(band < FLAGSHIP_BAND, f"phase 16b {name} bf16={on}: "
                  f"|mse - v| / v = {band:.3g} over the lanes (band "
                  f"{FLAGSHIP_BAND})")
            print(f"phase 16b flagship f32, {LANES} lanes, {name}, "
                  f"MATVEC_BF16={on}: {int(conv.sum())} converged, "
                  f"{its} iterations (per lane {int(n_iter.min())} to {its},"
                  f" mean {float(n_iter.double().mean()):.2f}), "
                  f"{walls[0]:.4f} / {walls[1]:.4f} s, wall "
                  f"{1e3 * walls[0] / its:.4f} / {1e3 * walls[1] / its:.4f} "
                  f"ms per iteration, device {dev:.4f} ms per iteration "
                  f"({windows[on]['kernels']:.1f} kernels), busy "
                  f"{100 * dev * its / (1e3 * walls[0]):.2f}% / "
                  f"{100 * dev * its / (1e3 * walls[1]):.2f}%, peak "
                  f"{peak} B, |mse - v| / v {band:.3e} over the lanes, "
                  f"worst lane {float(lanes_band.max()):.3e}, "
                  f"{int((lanes_band < FLAGSHIP_BAND).sum())} lanes inside "
                  f"the band [{card}]")
            for op, count, ms in windows[on]["top"][:3]:
                print(f"    {ms:9.4f} ms in {count:5.1f} launches per "
                      f"iteration: {op}")
            if name.startswith("EPSolver") and not on:
                ep_f32 = runs[on][0]
        v_rel = float(((v[True] - v[False]).abs() / v[False]).max())
        check(v_rel < V_MSE_BOUND, f"phase 16b {name}: a lane's mean v with "
              f"bf16 products is {v_rel:.3g} off the f32 solve's (bound "
              f"{V_MSE_BOUND})")
        print(f"phase 16b {name}: bf16 against f32 products, worst lane's "
              f"mean v {v_rel:.3e} (bound {V_MSE_BOUND}) [{card}]")
    return stacked, x, ep_f32


def gated_phases(torch, pl, solver, stacked, lanes, coarse):
    """``solve_batch_gated_bf16``'s two phases one by one, each timed and
    counted from 0: ((state1, n1, conv1, wall1, launches1), (post, n2,
    conv2, wall2, launches2))."""
    def phase(bf16, run):
        return solver._stored_as(bf16, lambda: solve_readings(
            torch, pl, run, lanes, peak=False))
    p1 = {}

    def first():
        post, state, n_iter, conv = solver._solve_batch(stacked, tol=coarse)
        p1["state"] = state
        return post, state, n_iter, conv
    _, n1, c1, w1, _, l1 = phase(True, first)
    upcast = solver._upcast_state(p1["state"])
    post, n2, c2, w2, _, l2 = phase(
        False, lambda: solver._solve_batch(stacked, state=upcast))
    return (p1["state"], n1, c1, w1, l1), (post, n2, c2, w2, l2)


def gated_arms(torch, pl, solver, stacked, card, what):
    """A (float32, one phase) against B (the two phases of
    solve_batch_gated_bf16) on ``stacked``, in turns A, B, B, A, with
    bench_gated's fields (bench.py:443-465). Checks that B's phases are
    the public call's, that no kernel ran, that the coarse stop fired and
    that B's polish converged every lane. Returns the fields."""
    coarse = solver._coarse_default()
    solver._stored_as(True, lambda: solver._solve_batch(stacked, tol=coarse))
    A, B = [], []
    for arm in "ABBA":
        if arm == "A":
            A.append(solve_readings(torch, pl,
                                    lambda: solver._solve_batch(stacked),
                                    LANES))
        else:
            B.append(gated_phases(torch, pl, solver, stacked, LANES, coarse))
    post_f, n_f, conv_f, _, _, _ = A[0]
    (_, n1, c1, _, l1), (post_g, n2, conv_g, _, l2) = B[0]
    whole = solver.solve_batch_gated_bf16(stacked)
    check(torch.equal(whole[1], n1 + n2) and torch.equal(
        whole[0]["x"]["r"], post_g["x"]["r"]),
        f"{what}: solve_batch_gated_bf16 differs from its two phases")
    check(not any(l1.values()) and not any(l2.values()),
          f"{what}: the flagship ran kernels {l1}, {l2}")
    v_f = post_f["x"]["v"].double()
    v_g = post_g["x"]["v"].double()
    t_f32 = [a[3] for a in A]
    t1 = [b[0][3] for b in B]
    t2 = [b[1][3] for b in B]
    info = {"stop_kind": solver.stop_kind, "tol": solver.tol,
            "coarse_tol": coarse,
            "t_f32_s": t_f32, "t_phase1_bf16_s": t1, "t_phase2_f32_s": t2,
            "t_two_phase_bf16_s": [a + b for a, b in zip(t1, t2)],
            "n_iter_f32_single_phase_mean": float(n_f.double().mean()),
            "loop_iterations_f32": int(n_f.max()),
            "n_iter_bf16_mean": float(n1.double().mean()),
            "n_iter_f32_mean": float(n2.double().mean()),
            "loop_iterations_bf16_f32": [int(n1.max()), int(n2.max())],
            "coarse_fired_frac": float(c1.double().mean()),
            "unconv_frac": float(1.0 - conv_g.double().mean()),
            "unconv_frac_f32": float(1.0 - conv_f.double().mean()),
            "v_rel_err_vs_f32": float((v_g - v_f).abs().max()
                                      / v_f.abs().max())}
    print(f"{what} [{card}]: {json.dumps(info)}")
    check(bool(c1.all()) and bool(conv_g.all()),
          f"{what}: the coarse stop fired on {int(c1.sum())} lanes, "
          f"{int((~conv_g).sum())} lanes unconverged after B's polish")
    return info


def phase_16c_gated(torch, tt, pl, student, stacked, ep_f32, card):
    """bench_gated's protocol (bench.py:336-467) on the card, the flagship's
    LANES lanes: EPSolver(damping=0.1, max_iter=300, tol=1e-6,
    stop_kind="v"), A against B (``gated_arms``), every field printed. With
    stop kind "v" at 1e-6 the float32 one-phase solve A stops early on
    some lanes (a sweep whose mean v barely moves; on the H100, lane 948
    after 10 sweeps at 2.87e-2 of its converged v, B at 5.6e-3), so
    v_rel_err_vs_f32 measures A's early stops, and the 1e-3 bound of
    tests/test_parallel.py:305, a kind-"r" test, is held on a second run of
    the protocol with stop kind "r" at phase 7's float32 batch tol 1e-5,
    where both A and B reach their fixed point."""
    from tramp_tpu_torch.parallel import EPSolver
    check(bool(ep_f32[2].all()), f"phase 16c: A left "
          f"{int((~ep_f32[2]).sum())} lanes unconverged at tol "
          f"{GATED_SOLVE['tol']}")
    info = {"v": gated_arms(
        torch, pl, EPSolver(student, **GATED_SOLVE), stacked, card,
        f"phase 16c bench_gated, flagship f32, {LANES} lanes, stop kind v")}
    kind_r = dict(GATED_SOLVE, stop_kind="r", tol=BATCH_TOL)
    info["r"] = gated_arms(
        torch, pl, EPSolver(student, **kind_r), stacked, card,
        f"phase 16c bench_gated, flagship f32, {LANES} lanes, stop kind r, "
        f"tol {BATCH_TOL}")
    v_rel = info["r"]["v_rel_err_vs_f32"]
    check(v_rel < GATED_V_REL, f"phase 16c, stop kind r: v_rel_err_vs_f32 "
          f"{v_rel:.3g} (bound {GATED_V_REL})")
    return info


def phase_16d_relu_net(torch, tt, pl, students, card):
    """The relu net (N = 4096, LANES lanes, f32) through
    EPSolver.solve_batch_gated_bf16 (tol BATCH_TOL) and one instance through
    solve_gated_bf16: 1 + 1 message launches per loop iteration in both
    phases, every lane converged, mean v within GATED_V_REL of the float32
    solve. Returns launches by path."""
    from tramp_tpu_torch.parallel import EPSolver, with_buffers
    student, _, linear = students["float32"]
    likelihood = len(student.factors) - 1
    _, ys = batch_of_observations(torch, linear.W, LANES, True, seed=16)
    stacked = with_buffers(student, {(likelihood, "y"): ys})
    solver = EPSolver(student, **dict(SOLVE, tol=BATCH_TOL))
    coarse = solver._coarse_default()
    post_f, n_f, conv_f, wall_f, _, _ = solve_readings(
        torch, pl, lambda: solver._solve_batch(stacked), LANES)
    (_, n1, c1, w1, l1), (post, n2, conv, w2, l2) = gated_phases(
        torch, pl, solver, stacked, LANES, coarse)
    paths = {}
    for phase, n, launches in (("bf16", n1, l1), ("f32", n2, l2)):
        its = int(n.max())
        check(launches["pl_forward_message"] == its
              and launches["pl_backward_message"] == its
              and launches["pl_posterior"] == 0,
              f"phase 16d gated relu net, {phase} phase: launches "
              f"{launches} for {its} loop iterations")
        paths[f"gated_relu_net_batch_{phase}"] = launches
    reset_launches(pl)
    whole = solver.solve_batch_gated_bf16(stacked)
    torch.cuda.synchronize()
    total = read_launches(pl)
    check(torch.equal(whole[1], n1 + n2)
          and torch.equal(whole[0]["x"]["r"], post["x"]["r"])
          and total["pl_forward_message"] == int(n1.max()) + int(n2.max()),
          f"phase 16d: solve_batch_gated_bf16 differs from its phases "
          f"(launches {total})")
    check(bool(conv.all()), f"phase 16d: {int((~conv).sum())} lanes "
          "unconverged")
    v_rel = float(((post["x"]["v"].double() - post_f["x"]["v"].double())
                   .abs() / post_f["x"]["v"].double()).max())
    check(v_rel < GATED_V_REL, f"phase 16d: a lane's mean v {v_rel:.3g} off "
          f"the f32 solve (bound {GATED_V_REL})")
    print(f"phase 16d relu net f32, {LANES} lanes, solve_batch_gated_bf16 "
          f"(tol {BATCH_TOL}): bf16 phase {int(n1.max())} iterations (mean "
          f"{float(n1.double().mean()):.2f}, coarse stop on "
          f"{int(c1.sum())} lanes) in {w1:.4f} s, f32 phase "
          f"{int(n2.max())} iterations (mean "
          f"{float(n2.double().mean()):.2f}) in {w2:.4f} s; float32 one "
          f"phase {int(n_f.max())} iterations in {wall_f:.4f} s; every "
          f"lane converged; worst lane's mean v {v_rel:.3e} off the f32 "
          f"solve (bound {GATED_V_REL}); launches {l1} + {l2} [{card}]")
    post_1, _, conv_1 = solver.solve_info(student)
    reset_launches(pl)
    post_g, n_total, conv_g, info = solver.solve_gated_bf16(student)
    torch.cuda.synchronize()
    one = read_launches(pl)
    check(bool(conv_g) and one["pl_forward_message"] == n_total
          and one["pl_backward_message"] == n_total
          and one["pl_posterior"] == 0,
          f"phase 16d one instance: conv {bool(conv_g)}, launches {one} for "
          f"{n_total} sweeps ({info})")
    v_1 = float(post_1["x"]["v"])
    v_rel_1 = abs(float(post_g["x"]["v"]) - v_1) / v_1
    check(v_rel_1 < GATED_V_REL, f"phase 16d one instance: mean v "
          f"{v_rel_1:.3g} off the f32 solve")
    print(f"phase 16d relu net f32, one instance, solve_gated_bf16: info "
          f"{info}, mean v {v_rel_1:.3e} off the f32 solve, launches {one} "
          f"[{card}]")
    paths["gated_relu_net_one_instance"] = one
    return paths


def flagship_float64(torch, tt, student, linear):
    """The flagship in float64: phase 5's W and y (float32 values) in a
    float64 model, its SVD on the card."""
    from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    W = linear.W.double()
    kw = dict(device="cuda", dtype=torch.float64)
    teacher = (GaussBernoulliPrior(size=W.shape[1], rho=RHO, **kw)
               @ tt.V(id="x") @ LinearChannel(W, name="W", **kw)
               @ tt.V(id="z") @ GaussianChannel(var=NOISE)
               @ tt.O(id="y")).to_model()
    return teacher.to_observed({"y": student.factors[-1].y.double()})


def phase_16e_pinned(torch, tt, pl, student, linear, card):
    """PIN_CONSTANT_MESSAGES on the flagship, one instance, through the
    engine: the JAX package's pinned slots; the same fixed point: r against
    the unpinned solve's at the JAX test's tolerance, in float64 and with
    both solves run to tol 1e-10 (two stops at tol 1e-6 from other
    transients lie about 1e-6 apart, and float32 rounding alone exceeds
    atol 1e-9: the float32 pair at tol 1e-6 is a reading); float32 sweeps
    in turns (unpinned, pinned, pinned, unpinned)."""
    def pinned_engine(model):
        return switched("PIN_CONSTANT_MESSAGES", True,
                        lambda: tt.ExpectationPropagation(model))
    t0 = time.perf_counter()
    student64 = flagship_float64(torch, tt, student, linear)
    reset_launches(pl)
    plain64 = tt.ExpectationPropagation(student64).iterate(**PIN_SOLVE)
    pinned64 = pinned_engine(student64).iterate(**PIN_SOLVE)
    torch.cuda.synchronize()
    launches = read_launches(pl)
    r, r0 = (e.get_variable_data("x")["r"] for e in (pinned64, plain64))
    worst = float(((r - r0).abs() / (PIN_ATOL + PIN_RTOL * r0.abs())).max())
    check(worst <= 1.0 and not any(launches.values()),
          f"phase 16e: float64 pinned r off the unpinned solve's by "
          f"{worst:.3g} of rtol {PIN_RTOL}, atol {PIN_ATOL}; launches "
          f"{launches}")
    plain = tt.ExpectationPropagation(student).iterate(**SOLVE)
    pinned = pinned_engine(student)
    for ep in (pinned, pinned64):
        check((ep.pinned_factor, ep.pinned_variable) == PINNED_FLAGSHIP
              and ep.spectral_factors == () and not plain.pinned,
              f"phase 16e: pinned {ep.pinned_factor}, "
              f"{ep.pinned_variable}, carry {ep.spectral_factors}")
    pinned.iterate(**SOLVE)
    r32, r032 = (e.get_variable_data("x")["r"].double()
                 for e in (pinned, plain))
    print(f"phase 16e flagship, one instance, pinned: slots "
          f"{pinned.pinned_factor}, cavities {pinned.pinned_variable}, no "
          f"carried image; float64 {pinned64.n_iter} sweeps against "
          f"{plain64.n_iter} unpinned, r within {worst:.3e} of rtol "
          f"{PIN_RTOL}, atol {PIN_ATOL}; float32 {pinned.n_iter} against "
          f"{plain.n_iter}, r within "
          f"{float((r32 - r032).abs().max() / r032.abs().max()):.3e} of "
          f"the largest |r| ({time.perf_counter() - t0:.1f} s with the "
          f"float64 SVD) [{card}]")
    for label, ep in (("unpinned", plain), ("pinned", pinned),
                      ("pinned", pinned), ("unpinned", plain)):
        kernels, device, wall_ms = sweep_window(ep)
        print(f"phase 16e flagship f32, {label}, torch.profiler over 10 "
              f"warm sweeps: {kernels:.1f} kernels, device {device:.4f} ms "
              f"of {wall_ms:.4f} ms per sweep, busy "
              f"{100 * device / wall_ms:.2f}% [{card}]")
    return launches


def phase_16(torch, tt, pl, students, flagship, card):
    """Phase 16: the reduced-precision throughput mode on the card. Returns
    launches by path."""
    t0 = time.perf_counter()
    student, linear = flagship
    phase_16a_products(torch, linear, card)
    stacked, _, ep_f32 = phase_16b_flagship(torch, tt, pl, student, linear,
                                            card)
    phase_16c_gated(torch, tt, pl, student, stacked, ep_f32, card)
    del stacked, ep_f32
    paths = phase_16d_relu_net(torch, tt, pl, students, card)
    paths["pinned_flagship"] = phase_16e_pinned(torch, tt, pl, student,
                                                linear, card)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s [{card}]")
    return paths


# -- phase 17: the gallery -------------------------------------------------
GALLERY_SE_RTOL = 1e-8   # card against the JAX package's committed outputs
# the JMLR points' atol: in the deep-recovery branch SE stops (tol 1e-6,
# max_iter 200) with v still falling geometrically toward the noise floor,
# up to 3.5e-7 where EP's mse is 1e-10; both are perfect recovery on the
# signal's scale (variance 0.5 and 0.6). tests/test_ep_golden.py:98-103
# takes 1e-7 for a row whose v_SE is 5.6e-8.
GALLERY_EP_ATOL = 1e-6
# the JMLR points' finite-N allowance, relative to v_SE: the golden test's
# v_EP-vs-SE allowance at N = 1000 (tests/test_ep_golden.py:114-115)
GALLERY_EP_FINITE_N = 0.05
# matrix_factorization's mse_x_emp: the VAMP solve amplifies rounding about
# 1e9 (ROADMAP Queue 3), so the committed value is held in the band of an
# ensemble of the same instances with the input perturbed by 1e-13 relative
MF_CHAOS = dict(solves=12, eps=1e-13)
# the EP alphas of the two JMLR protocols run at full width: indices into
# their --big grids (sparse_regression: linspace(0.03, 0.99, 33);
# sparse_phase_retrieval: linspace(0.03, 1.2, 40))
JMLR_EP_POINTS = {"sparse_regression": (0, 8, 16, 24, 32),
                  "sparse_phase_retrieval": (0, 13, 26, 39)}
#: the JMLR points held outside the SE band: sparse phase retrieval at
#: alpha 0.81 and 1.2 (indices 26, 39), where SE from a0 = 0.1 lies below
#: the symmetric point (at 1.2 it recovers) but the JAX script's EP
#: protocol stops near the symmetric fixed point on every seed at N = 1000
#: (tests/test_torch_examples_spr.py, test_torch_examples_spr_n1000.py)
JMLR_STALLED = {"sparse_phase_retrieval": (0.81, 1.2)}
#: the least share of a stalled point's lanes whose mse lies above half
#: their signal's power mean(x**2)
JMLR_STALLED_SHARE = 0.8
#: converged lanes of a stalled JMLR point re-solved on the CPU
JMLR_CPU_LANES = 3
COMMITTED = {
    "compressed_sensing":
        "examples/glm/output/compressed_sensing_ep_vs_se.csv",
    "perceptron": "examples/glm/output/perceptron_ep_vs_se.csv",
    "phase_diagram": "examples/figures/output/phase_diagram.csv",
    "matrix_factorization":
        "examples/low_rank/output/matrix_factorization_ep_vs_se.csv",
}


def gallery_dir(name):
    "A scratch output directory of phase 17 inside the checkout (ignored)."
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "phase17", name)
    os.makedirs(path, exist_ok=True)
    return path


def committed_columns(name):
    """The columns of a CSV the JAX package committed under examples/, by
    header name (pandas' header or np.savetxt's '# ...' line)."""
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        COMMITTED[name])
    with open(path) as f:
        header = f.readline().lstrip("# ").strip().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return {h: data[:, i] for i, h in enumerate(header)}


def hold_column(what, got, want, rtol, card,
                against="the JAX package's committed outputs"):
    "Each element of ``got`` within rtol of ``want`` (relative)."
    got, want = np.asarray(got, float), np.asarray(want, float)
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{what}: {got.shape} against {want.shape}, or not finite")
    rel = np.abs(got - want) / np.abs(want)
    check(bool((rel <= rtol).all()),
          f"{what}: {int((rel > rtol).sum())} of {rel.size} off {against} "
          f"by more than rtol {rtol:g} (worst {rel.max():.3g})")
    print(f"{what}: {rel.size} values within rtol {rtol:g} of {against} "
          f"(worst {rel.max():.3e}) [{card}]")


def gallery_path(torch, pl, paths, name, run):
    """``run()`` as one path of the gallery: the kernels' counts set to 0
    just before and read just after, into ``paths[name]``. Returns (its
    result, seconds)."""
    torch.cuda.synchronize()
    reset_launches(pl)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    paths[f"gallery_{name}"] = read_launches(pl)
    return out, time.perf_counter() - t0


def phase_17a_se_columns(torch, pl, paths, card):
    """The scripts whose SE columns the JAX package committed, at their
    default sizes on the card: every SE value against the committed file
    (rtol GALLERY_SE_RTOL), the EP columns finite and printed."""
    from tramp_tpu_torch.examples.glm import compressed_sensing, perceptron
    from tramp_tpu_torch.examples.figures import phase_diagram_sweep
    from tramp_tpu_torch.examples.low_rank import matrix_factorization
    for name, module in (("compressed_sensing", compressed_sensing),
                         ("perceptron", perceptron)):
        df, s = gallery_path(torch, pl, paths, name, lambda: module.main(
            ["--out", gallery_dir("glm")]))
        want = committed_columns(name)
        check(list(df.columns) == ["v_EP", "mse_EP", "v_SE", "alpha",
                                   "seed"]
              and np.array_equal(df["alpha"].to_numpy(), want["alpha"]),
              f"{name}: columns {list(df.columns)}, alphas "
              f"{df['alpha'].tolist()}")
        check(np.isfinite(df[["v_EP", "mse_EP"]].to_numpy()).all(),
              f"{name}: EP columns not finite")
        hold_column(f"gallery {name} v_SE", df["v_SE"], want["v_SE"],
                    GALLERY_SE_RTOL, card)
        print(f"gallery {name} (N=250, {len(df)} alphas, {s:.2f} s): "
              + "; ".join(f"alpha {a:g} v_EP {v:.4g} mse_EP {m:.4g} v_SE "
                          f"{w:.4g}" for a, v, m, w in zip(
                              df["alpha"], df["v_EP"], df["mse_EP"],
                              df["v_SE"])) + f" [{card}]")
    out, s = gallery_path(torch, pl, paths, "phase_diagram", lambda:
                          phase_diagram_sweep.main(
                              ["--out", gallery_dir("figures")]))
    want = committed_columns("phase_diagram")
    check(np.array_equal(np.asarray(out["points"]),
                         np.stack([want["alpha"], want["rho"]], 1)),
          "phase diagram: the grid differs from the committed one")
    hold_column("gallery phase_diagram_sweep v_SE (96 points)", out["v"],
                want["v_SE"], GALLERY_SE_RTOL, card)
    print(f"gallery phase_diagram_sweep, 96 points on the one-rank nccl "
          f"mesh: {out['seconds']:.4f} s, "
          f"{len(out['points']) / out['seconds']:.1f} points/s [{card}]")
    rows, s = gallery_path(torch, pl, paths, "matrix_factorization", lambda:
                           matrix_factorization.main(
                               ["--out", gallery_dir("low_rank")]))
    rows = np.asarray(rows)
    want = committed_columns("matrix_factorization")
    check(np.array_equal(rows[:, 0], want["delta"]),
          f"matrix factorization: Deltas {rows[:, 0]}")
    hold_column("gallery matrix_factorization mse_x_se", rows[:, 2],
                want["mse_x_se"], GALLERY_SE_RTOL, card)
    spread = []
    for Delta, emp, committed in zip(rows[:, 0], rows[:, 1],
                                     want["mse_x_emp"]):
        runs = chaos_ensemble(torch, Delta)
        mean, sd = float(runs.mean()), float(runs.std(ddof=1))
        spread.append(sd / mean)
        for what, value in (("the committed", committed), ("the card's",
                                                           emp)):
            check(abs(value - mean) <= 3.3 * sd,
                  f"matrix factorization Delta {Delta}: {what} mse_x_emp "
                  f"{value:.6g} outside {mean:.6g} +- 3.3 x {sd:.3g}")
    print(f"gallery matrix_factorization (M=N=128, 4 seeds as lanes, f64, "
          f"{s:.2f} s): " + "; ".join(
              f"Delta {d:g} mse_x {e:.5g} (committed {c:.5g}) SE {p:.5g} "
              f"vz_u {v:.4g}" for (d, e, p, v), c in zip(
                  rows, want["mse_x_emp"])) + "; the committed and the "
          f"card's mse_x_emp within 3.3 sd of {MF_CHAOS['solves']} solves "
          f"with the input perturbed by {MF_CHAOS['eps']:g}: relative sd "
          + ", ".join(f"{x:.4g}" for x in spread) + f" [{card}]")


def chaos_ensemble(torch, Delta, M=128, N=128, K=2, seeds=4):
    """mse_x_emp of matrix_factorization's default instances at Delta
    (RandomState(7)) over MF_CHAOS["solves"] solves, the first on the
    exact input, each other with the input multiplied by 1 + eps g, g
    standard normal from a generator seeded with the solve's index; the
    solves' instances are the lanes of one call of the solver, which
    freezes each lane where its own stop fires."""
    from tramp_tpu_torch.channels.low_rank import vamp_matrix_factorization
    from tramp_tpu_torch.examples.low_rank.matrix_factorization import (
        planted_instance)
    kw = dict(device="cuda", dtype=torch.float64)
    rng = np.random.RandomState(7)
    X0s, Ys = zip(*[planted_instance(M, N, K, Delta, rng)
                    for _ in range(seeds)])
    Y, X0 = torch.as_tensor(np.stack(Ys), **kw), torch.as_tensor(
        np.stack(X0s), **kw)
    solves = MF_CHAOS["solves"]
    bx = torch.cat([Y * (1 + MF_CHAOS["eps"] * torch.randn(
        Y.shape, generator=torch.Generator(device="cuda").manual_seed(i),
        **kw)) if i else Y for i in range(solves)]) / Delta
    ru, _, rv, _ = vamp_matrix_factorization(
        au=1.0, av=1.0, bu=torch.zeros((M, K), **kw),
        bv=torch.zeros((N, K), **kw), ax=1.0 / Delta, bx=bx, model="UV")
    Xh = torch.einsum("smk,snk->smn", ru, rv) / math.sqrt(N)
    err = (Xh.reshape(solves, seeds, M, N) - X0) ** 2
    return err.mean(dim=(1, 2, 3)).cpu().numpy()


def phase_17b_door(torch, pl, paths, card):
    "The door's critical alphas and its batched line over p_pos."
    from tramp_tpu_torch.examples.glm import critical_alpha_door as door
    found, s = gallery_path(torch, pl, paths, "critical_alpha_door",
                            lambda: door.main([]))
    for criterion, ref in door.REFERENCE:
        check(abs(found[criterion] - ref) <= ALPHA_TOL,
              f"door {criterion}: alpha_c {found[criterion]} against {ref}")
    check(abs(found["line"][0] - dict(door.REFERENCE)["perfect"])
          <= ALPHA_TOL, f"door line at p_pos 0.51: {found['line'][0]}")
    print(f"gallery critical_alpha_door: random {found['random']!r}, "
          f"perfect {found['perfect']!r} (within {ALPHA_TOL:g} of "
          f"{door.REFERENCE}); the batched line over p_pos "
          f"{door.P_POS}: {found['line']}; {s:.2f} s [{card}]")


def jmlr_protocol(torch, pl, paths, name, module, extra, card):
    """One JMLR protocol at full width: N = 2000, 25 seeds as the lanes of
    one EPSolver.solve_batch per alpha of JMLR_EP_POINTS, each point's
    mean within 3.3 sd / sqrt(seeds) + GALLERY_EP_FINITE_N v_SE +
    GALLERY_EP_ATOL of v_SE, except at the alphas JMLR_STALLED names:
    there SE lies below the symmetric point (v_SE < the lanes' mean
    mean(x**2)), at least JMLR_STALLED_SHARE of the lanes stop near it as
    in the JAX protocol (mse > mean(x**2) / 2), and the first
    JMLR_CPU_LANES converged lanes are held against the CPU;
    the SE and BO curves at their --big point counts; at the default grid,
    card against the port's own CPU run (rtol GALLERY_SE_RTOL)."""
    N, n_seeds, alphas, se_alphas = module.grids(True)
    alphas = alphas[list(JMLR_EP_POINTS[name])]
    v_se = [r["v"] for r in module.run_se_curve(alphas, *extra, "SE",
                                                "cuda")]
    reset_launches(pl)
    for alpha, v in zip(alphas, v_se):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        students, x_true = module.students(alpha, N, *extra, n_seeds,
                                           torch.device("cuda"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mses, post, n_iter = module.ep_batch(students, x_true)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(np.isfinite(mses).all(), f"{name} alpha {alpha:.4g}: mse "
                                       "not finite")
        mean, sd = float(mses.mean()), float(mses.std(ddof=1))
        gap = abs(mean - v)
        line = (f"gallery {name} EP alpha={alpha:.4g}, N={N}, {n_seeds} "
                f"seeds as lanes: mse {mean:.6g} (sd {sd:.3g}) vs v_SE "
                f"{v:.6g}, |gap| {gap:.3g}; n_iter "
                f"{int(n_iter.min())}-{int(n_iter.max())}; {n_seeds} students "
                f"(SVDs) {t1 - t0:.2f} s, the batched solve {t2 - t1:.2f} s")
        if np.isclose(alpha, JMLR_STALLED.get(name, ()), rtol=0,
                      atol=1e-12).any():
            power = np.array([float((x.double() ** 2).mean())
                              for x in x_true])
            stalled = int((mses > power / 2).sum())
            check(v < power.mean()
                  and stalled >= JMLR_STALLED_SHARE * n_seeds,
                  f"{line}: v_SE {v:.3g} (should lie below the symmetric "
                  f"point, {power.mean():.3g}), {stalled} of {n_seeds} lanes "
                  f"with mse > mean(x**2) / 2 (at least "
                  f"{JMLR_STALLED_SHARE:g} of them should)")
            lanes = jmlr_lanes_on_cpu(torch, students, x_true, post, n_iter,
                                      module, line)
            line += (f"; SE below the symmetric point and EP stopped near it"
                     f" as in the JAX protocol: {stalled} of {n_seeds} lanes "
                     f"with mse > mean(x**2) / 2 (mse / mean(x**2) "
                     f"{(mses / power).min():.3g}-{(mses / power).max():.3g})"
                     f", lanes {lanes} held against the CPU")
        else:
            band = (3.3 * sd / math.sqrt(n_seeds) + GALLERY_EP_FINITE_N * v
                    + GALLERY_EP_ATOL)
            check(gap <= band, f"{line} > 3.3 sd / sqrt({n_seeds}) + "
                               f"{GALLERY_EP_FINITE_N:g} v_SE + "
                               f"{GALLERY_EP_ATOL:g} = {band:.3g}")
            line += (f" <= 3.3 sd / sqrt({n_seeds}) + {GALLERY_EP_FINITE_N:g}"
                     f" v_SE + {GALLERY_EP_ATOL:g} = {band:.3g}")
        print(line + f" [{card}]")
        del students, post
    paths[f"gallery_{name}_ep"] = read_launches(pl)
    for source in ("SE", "BO"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = module.run_se_curve(se_alphas, *extra, source, "cuda")
        s = time.perf_counter() - t0
        v = np.array([r["v"] for r in recs])
        check(np.isfinite(v).all(), f"{name} {source}: not finite")
        print(f"gallery {name} {source} curve, {len(v)} points (--big) in "
              f"one SESolver.solve_batch: {s:.3f} s, "
              f"{len(v) / s:.1f} points/s, v from {v.min():.4g} to "
              f"{v.max():.4g} [{card}]")
        small = module.grids(False)[3]
        gpu = [r["v"] for r in module.run_se_curve(small, *extra, source,
                                                   "cuda")]
        cpu = [r["v"] for r in module.run_se_curve(
            small, *extra, source, torch.device("cpu"))]
        hold_column(f"gallery {name} {source} curve ({len(small)} points) "
                    "on the card", gpu, cpu, GALLERY_SE_RTOL, card,
                    against="the same grid on the CPU")


def jmlr_lanes_on_cpu(torch, students, x_true, post, n_iter, module, what):
    """The first JMLR_CPU_LANES converged lanes of a batched EP solve on the
    card (n_iter below max_iter: a lane stopped by max_iter is at no fixed
    point) against the same lanes solved as a batch on the CPU: n_iter
    within 2 and r within R_TOL of the largest |r| (phase 7's batch rule;
    done lanes are frozen, so a lane does not depend on the others).
    Returns the lanes."""
    done = (n_iter.cpu() < module.EP_SOLVE["max_iter"]).nonzero()
    lanes = done.flatten()[:JMLR_CPU_LANES].tolist()
    check(len(lanes) == JMLR_CPU_LANES,
          f"{what}: {len(lanes)} converged lanes, {JMLR_CPU_LANES} needed")
    _, cpu_post, cpu_n = module.ep_batch(
        [on_card(torch, students[i], "cpu") for i in lanes],
        [x_true[i].cpu() for i in lanes])
    got = post["x"]["r"][lanes].double().cpu()
    err = rel_to_largest(torch, got, cpu_post["x"]["r"].double())
    dn = (n_iter[lanes].cpu() - cpu_n).abs().max()
    check(err <= R_TOL and int(dn) <= 2,
          f"{what}: lanes {lanes} against the CPU: r {err:.3g} of the "
          f"largest |r|, n_iter off by {int(dn)}")
    return lanes


def phase_17c_jmlr(torch, pl, paths, card):
    from tramp_tpu_torch.examples.figures import (
        sparse_regression as sr, sparse_phase_retrieval as spr)
    jmlr_protocol(torch, pl, paths, "sparse_regression", sr,
                  (sr.RHO, sr.NOISE_VAR), card)
    jmlr_protocol(torch, pl, paths, "sparse_phase_retrieval", spr,
                  (spr.RHO,), card)


def phase_17d_phase_diagram(torch, pl, paths, card):
    "phase_diagram_sweep --big: 1000 points as one solve, its points/s."
    from tramp_tpu_torch.examples.figures import phase_diagram_sweep
    out, s = gallery_path(torch, pl, paths, "phase_diagram_big", lambda:
                          phase_diagram_sweep.main(
                              ["--big", "--out",
                               gallery_dir("figures_big")]))
    check(len(out["v"]) == 1000 and np.isfinite(out["v"]).all(),
          "phase diagram --big: not 1000 finite values")
    print(f"gallery phase_diagram_sweep --big: 1000 points in one "
          f"SESolver.solve_batch on the one-rank nccl mesh, "
          f"{out['seconds']:.4f} s, {1000 / out['seconds']:.1f} points/s "
          f"(the script's whole run {s:.2f} s) [{card}]")


def phase_17e_fast_paths(torch, pl, paths, card):
    """fast_paths on the card: the dispatched classes, exactly one launch
    of each message kernel per MLVAMPSolver iteration on the relu net, both
    message kernels against their plain twins at the inputs of its last
    iteration, and the gated solve's v within GATED_V_REL of float32."""
    from tramp_tpu_torch.channels import ReluChannel
    from tramp_tpu_torch.examples.glm import fast_paths
    last = {}
    originals = {m: getattr(ReluChannel, m) for m in (
        "compute_forward_message", "compute_backward_message")}

    def recording(method):
        def call(self, az, bz, ax, bx):
            last[method] = (az, bz, ax, bx, self.region_specs)
            return originals[method](self, az, bz, ax, bx)
        return call
    for m in originals:
        setattr(ReluChannel, m, recording(m))
    try:
        out, s = gallery_path(torch, pl, paths, "fast_paths",
                              lambda: fast_paths.main([]))
    finally:
        for m, fn in originals.items():
            setattr(ReluChannel, m, fn)
    glm, relu, gated = out["glm"], out["relu"], out["gated"]
    launches = paths["gallery_fast_paths"]
    check(glm["solver"] == "SpectralVAMPSolver"
          and relu["solver"] == "MLVAMPSolver",
          f"fast paths: dispatched {glm['solver']}, {relu['solver']}")
    check(launches["pl_forward_message"] == relu["n_iter"]
          and launches["pl_backward_message"] == relu["n_iter"]
          and launches["pl_posterior"] == 0,
          f"fast paths: launches {launches} for {relu['n_iter']} "
          "MLVAMPSolver iterations (want 1 + 1 per iteration)")
    check(gated["conv"] and gated["v_rel_err_vs_f32"] < GATED_V_REL,
          f"fast paths gated: conv {gated['conv']}, v_rel_err_vs_f32 "
          f"{gated['v_rel_err_vs_f32']:.3g}")
    err = {}
    for method, name, plain in (
            ("compute_forward_message", "pl_forward_message",
             pl.pl_forward_message_plain),
            ("compute_backward_message", "pl_backward_message",
             pl.pl_backward_message_plain)):
        az, bz, ax, bx, specs = last[method]
        got = getattr(pl, name)(az, bz, ax, bx, specs)
        want = plain(az, bz, ax, bx, specs)
        a, b = (ax, bx) if name == "pl_forward_message" else (az, bz)
        ratios = [hold_message(torch, f"fast paths {name} {k}", g, w, t,
                               RTOL["float32"])
                  for k, g, w, t in (("a_new", got[0], want[0], a),
                                     ("b_new", got[1], want[1], b))]
        err[name] = max(r[1] for r in ratios)
    print(f"gallery fast_paths ({s:.2f} s): GLM -> {glm['solver']} "
          f"n_iter {glm['n_iter']} mse {glm['mse']:.5g} (engine "
          f"{glm['mse_engine']:.5g}); relu net -> {relu['solver']} n_iter "
          f"{relu['n_iter']} mse {relu['mse']:.5g}, launches {launches} "
          f"(1 + 1 per iteration); message kernels against their plain "
          f"twins at the last iteration's inputs (rtol "
          f"{RTOL['float32']:g}), max abs err {err}; gated: bf16 "
          f"{gated['n_iter_bf16']} + f32 {gated['n_iter_f32']} sweeps, "
          f"conv {gated['conv']}, v_rel_err_vs_f32 "
          f"{gated['v_rel_err_vs_f32']:.3e} < {GATED_V_REL:g} [{card}]")
    return err


def phase_17f_golden_rows(torch, pl, paths, card):
    "tests/test_ep_golden.py's rows: 8 seeds of N = 1000 per row as lanes."
    from tramp_tpu_torch.examples.glm import golden_rows
    records, s = gallery_path(torch, pl, paths, "ep_golden_rows",
                              lambda: golden_rows.hold_rows(
                                  torch.device("cuda")))
    for rec in records:
        line = (f"EP golden row {rec['family']} alpha={rec['alpha']:.6g}: "
                f"v_EP {rec['v_ep']:.6g} mse {rec['mse']:.6g} n_iter <= "
                f"{rec['n_iter']}; ")
        line += ", ".join(f"{k} |gap| {gap:.3g} <= {band:.3g}"
                          for k, (ok, gap, band) in rec["checks"].items())
        check(all(ok for ok, _, _ in rec["checks"].values()),
              line + " (outside its band)")
        print(line + f" [{card}]")
    print(f"EP golden rows: {len(records)} rows, one EPSolver.solve_batch "
          f"of {golden_rows.N_SEEDS} lanes each, {s:.2f} s [{card}]")


def phase_17g_rest(torch, pl, paths, card):
    """Every other script at its default size on the card, its task-level
    numbers printed."""
    from tramp_tpu_torch.examples.glm import (
        phase_retrieval, two_layer_phase_retrieval, cs_universality)
    from tramp_tpu_torch.examples.figures import se_grid_scaling, benchmark
    from tramp_tpu_torch.examples.sparse import (
        sparse_gradient, sparse_fft, image_deconvolution, image_denoising)
    from tramp_tpu_torch.examples.vae_prior import inpainting
    glm, fig = ["--out", gallery_dir("glm")], ["--out", gallery_dir("figures")]
    sparse = ["--out", gallery_dir("sparse")]
    runs = [
        ("phase_retrieval", lambda: phase_retrieval.main(glm)),
        ("two_layer_phase_retrieval",
         lambda: two_layer_phase_retrieval.main(glm)),
        ("cs_universality", lambda: cs_universality.main(glm)),
        ("se_grid_scaling", lambda: se_grid_scaling.main(fig)),
        ("benchmark", lambda: benchmark.main(fig)),
        ("sparse_gradient", lambda: sparse_gradient.main(sparse)),
        ("sparse_fft", lambda: sparse_fft.main(sparse)),
        ("image_deconvolution", lambda: image_deconvolution.main(sparse)),
        ("image_denoising", lambda: image_denoising.main(sparse)),
        ("image_denoising_tv", lambda: image_denoising.main(sparse
                                                             + ["--tv"])),
        ("inpainting", lambda: inpainting.main(
            ["--out", gallery_dir("vae_prior")])),
    ]
    for name, run in runs:
        out, s = gallery_path(torch, pl, paths, name, run)
        print(f"gallery {name} at its default size: {s:.2f} s, launches "
              f"{paths['gallery_' + name]}; {gallery_summary(name, out)} "
              f"[{card}]")


def gallery_summary(name, out):
    """The task-level numbers of a script's result, checked finite: the
    rows of a DataFrame, or the scalars of a dict."""
    if name == "phase_retrieval":
        vals = out[["mse_EP", "v_EP"]].to_numpy()
        text = "; ".join(f"alpha {a:g} mse {m:.4g} v {v:.4g}" for a, m, v
                         in zip(out["alpha"], vals[:, 0], vals[:, 1]))
    elif name == "cs_universality":
        vals = out["v"].to_numpy()
        text = (f"{len(out)} rows; max |v_EP - v_SE| over the points "
                + f"{_universality_gap(out):.4g}")
    elif name == "se_grid_scaling":
        report = out[0]
        vals = np.array([report["flop_counter_flops_per_process"],
                         report["se_points_per_s"]])
        text = (f"FlopCounterMode (products only) "
                f"{vals[0]:.6g} FLOPs per process, {vals[1]:.1f} SE "
                "points/s")
    elif name == "benchmark":
        vals = out["ep_mse"].to_numpy()
        text = "; ".join(f"alpha {a:g} seed {s} ep_mse {m:.4g} ep_time "
                         f"{t:.4f} s lasso_mse {lm:.4g}" for a, s, m, t, lm
                         in zip(out["alpha"], out["seed"], out["ep_mse"],
                                out["ep_time"], out["lasso_mse"]))
    else:
        vals = np.array([v for v in out.values() if np.isscalar(v)],
                        dtype=float)
        text = ", ".join(f"{k} {v:.5g}" for k, v in out.items()
                         if np.isscalar(v))
    check(np.isfinite(vals).all(), f"gallery {name}: not finite ({text})")
    return text


def _universality_gap(df):
    se = df[df.source == "SE"].set_index(["f", "prior_rho", "alpha"])["v"]
    ep = df[df.source == "EP"].set_index(["f", "prior_rho", "alpha"])["v"]
    return float((ep - se).abs().max())


def phase_17(torch, pl, card):
    """Phase 17: the gallery (tramp_tpu_torch/examples) on the card.
    Returns (launches by path, the fast paths' message kernels' max abs
    error against their plain twins)."""
    t0 = time.perf_counter()
    paths, times, out = {}, {}, {}
    for part, run in (("17a", phase_17a_se_columns), ("17b", phase_17b_door),
                      ("17c", phase_17c_jmlr),
                      ("17d", phase_17d_phase_diagram),
                      ("17e", phase_17e_fast_paths),
                      ("17f", phase_17f_golden_rows),
                      ("17g", phase_17g_rest)):
        t1 = time.perf_counter()
        out[part] = run(torch, pl, paths, card)
        times[part] = time.perf_counter() - t1
    print(f"phase 17: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + f") [{card}]")
    return paths, out["17e"]


# -- phase 18: the root entry points (tramp_tpu_torch/graft_entry.py) -------
ENTRY_SWEEPS = 10
DRYRUN_STAGES = (1, 2, 4, 3)   # __graft_entry__.py:135-229's order


def phase_18(torch, pl, card):
    """Phase 18: ``graft_entry.entry()`` on the card, its ``fn`` applied
    ENTRY_SWEEPS times against ``iterate(max_iter=ENTRY_SWEEPS, tol=0)`` of
    the same student, bit for bit, with the kernels and device ms per sweep
    (loop_window); then ``dryrun_multichip(1)`` on one nccl rank: its four
    lines, in the JAX order, and its seconds. Returns the launches of the
    two paths, each counted from 0 (the flagship runs no kernel)."""
    import contextlib
    import io
    import torch.distributed as dist
    from tramp_tpu_torch import graft_entry
    from tramp_tpu_torch.algos import ExpectationPropagation
    t0 = time.perf_counter()
    fn, (student, state) = graft_entry.entry()
    check(all(t.is_cuda and t.dtype == torch.float32
              for msg in state for t in msg.values()),
          "entry: the example state is not float32 on the card")

    def sweeps(k):
        out = state
        for _ in range(k):
            out = fn(student, out)
        return out

    def run(k):
        "k sweeps and the finite check of their state as the readout"
        return torch.stack([torch.isfinite(t).all() for msg in sweeps(k)
                            for t in msg.values()]).all()

    paths = {}
    reset_launches(pl)
    out = sweeps(ENTRY_SWEEPS)
    torch.cuda.synchronize()
    paths["graft_entry_fn"] = read_launches(pl)
    ep = ExpectationPropagation(student).iterate(
        max_iter=ENTRY_SWEEPS, tol=0.0, damping=0.1)
    check(ep.n_iter == ENTRY_SWEEPS and same_state(torch, out, ep.state),
          f"entry: {ENTRY_SWEEPS} calls of fn differ from the engine's "
          f"{ep.n_iter} sweeps")
    check(bool(run(ENTRY_SWEEPS)), "entry: not finite")
    window = print_window(
        "graft_entry.entry() fn (flagship N=1024 float32, one sweep)",
        loop_window(run, ENTRY_SWEEPS), card)
    print(f"entry: {ENTRY_SWEEPS} calls of fn equal to iterate("
          f"max_iter={ENTRY_SWEEPS}, tol=0), bit for bit; "
          f"{window['kernels']:.1f} kernels and {window['device_ms']:.4f} "
          f"ms of device time per sweep [{card}]")

    lines = io.StringIO()
    reset_launches(pl)
    t1 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(lines):
            graft_entry.dryrun_multichip(1)
        torch.cuda.synchronize()
    finally:
        print(lines.getvalue(), end="")
    dry_s = time.perf_counter() - t1
    paths["graft_dryrun_multichip"] = read_launches(pl)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"dryrun: a {dist.get_backend()} world of "
          f"{dist.get_world_size()}")
    stages = [line.split(" OK:")[0] for line in lines.getvalue().splitlines()
              if line.startswith("dryrun_multichip stage")]
    check(stages == [f"dryrun_multichip stage{k}" for k in DRYRUN_STAGES],
          f"dryrun: stages {stages}")
    for path, launches in paths.items():
        check(not any(launches.values()), f"{path} ran kernels: {launches}")
    print(f"dryrun_multichip(1) on one nccl rank: {dry_s:.1f} s; phase 18 "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return paths


def main():
    import torch
    # phase 1: the device
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import tramp_tpu_torch as tt
        from tramp_tpu_torch import base
        from tramp_tpu_torch.channels.base_channel import Channel
        from tramp_tpu_torch.ops import pl_fused as pl
        from tramp_tpu_torch.channels import (
            SgnChannel, AbsChannel, ReluChannel, LeakyReluChannel,
            HardTanhChannel, SymmetricDoorChannel)
    except ImportError as e:
        check(False, f"tramp_tpu_torch not importable ({e}): run from the "
                     "root of a checkout")

    # phase 2: build
    t0 = time.perf_counter()
    lib_paths, log = pl.build()
    report = pl.ptxas_report(log)
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(p.name for p in lib_paths)}")
    for row in report:
        print(f"ptxas: {row['kernel']}<{row['dtype']}, "
              f"{', '.join(map(str, row['params']))}> "
              f"{row['registers']} registers, {row['spill_bytes']} "
              "bytes of spill stores")
        check(row["spill_bytes"] == 0 or row["params"][0] > 3,
              f"{row['kernel']} {row['dtype']} {row['params']} spills")
    if log:
        # (five-output + two message sides) x (with and without lanes)
        # x float types x region counts
        check(len(report) >= 3 * 2 * 2 * 8,
              f"ptxas reported {len(report)} kernels")
        print(f"ptxas: {len(report)} kernels in all, max "
              f"{max(r['registers'] for r in report)} registers, "
              f"{sum(r['spill_bytes'] for r in report)} bytes of spill "
              "stores (instantiations with 4 to 8 regions included)")
    else:
        print("ptxas: no report, the libraries were already built")

    # phase 3: kernels vs plain, and their times
    channels = [SgnChannel(), AbsChannel(), ReluChannel(),
                LeakyReluChannel(slope=0.3), HardTanhChannel(),
                SymmetricDoorChannel(width=0.7)]
    relu, tanh = channels[2], channels[4]
    max_err = {}
    max_err["pl_posterior"], (post_ms, post_plain_ms) = compare_posterior(
        torch, pl, channels)
    max_err.update(compare_messages(torch, pl, channels))
    for name, err in compare_lanes(torch, pl, (relu, tanh)).items():
        max_err[name] = max(max_err[name], err)
    # (its largest absolute errors are printed, not merged: at one element
    # a lane, a_new reaches 1e7 where the hard tanh's variance cancels)
    compare_lane_layouts(torch, pl, (relu, tanh, stairs()))
    time_fusion(torch, pl, base, relu.region_specs)
    table = kernel_table(torch, pl, (relu, tanh), card)
    main_args = inputs(torch, 2048, torch.float32, 3)
    plain_ms = {
        "pl_posterior": post_plain_ms,
        "pl_forward_message": per_call_ms(lambda: pl.pl_forward_message_plain(
            *main_args, relu.region_specs)),
        "pl_backward_message": per_call_ms(
            lambda: pl.pl_backward_message_plain(*main_args,
                                                 relu.region_specs))}
    print(f"plain versions at relu n=2048 float32, per call: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in plain_ms.items())
        + f"; pl_posterior kernel {post_ms:.4f} ms")
    lanes_err, lanes_plain_ms = hold_main_shape(torch, pl, relu)
    for name, err in lanes_err.items():
        max_err[name] = max(max_err[name], err)
    print(f"plain versions at relu float32, {LANES} lanes of n=2048, per "
          "call: " + ", ".join(f"{k} {v:.4f} ms"
                               for k, v in lanes_plain_ms.items()))
    se_err, se_rows = hold_se_shape(torch, pl, relu, card)
    max_err["pl_posterior"] = max(max_err["pl_posterior"], se_err)
    gb_cases = hold_gb_prior(torch, card)
    # the relu nets of phase 4, built here for the loop finish's states
    nets = {dtype_name(dtype): relu_net(torch, tt, dtype)
            for dtype in (torch.float32, torch.float64)}
    finish_cases = hold_ml_vamp_finish(torch, nets, card)

    # phase 4: the relu net through the kernels, f32 and f64
    class UnfusedReluChannel(ReluChannel):
        """The relu factor as the sweep ran it before the fusion: the
        five-output kernel, torch.mean and compute_ab_new."""
        compute_forward_message = Channel.compute_forward_message
        compute_backward_message = Channel.compute_backward_message

    results, students, engine_r = {}, {}, {}
    main_launches = readout_launches = None
    # the prior kernel's launches by main path
    gb_paths = {}
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        student, x0, linear = students[dname] = nets[dname]
        gb = {}
        ep, mse, v, wall, launches = solve(torch, tt, pl, student, x0, gb=gb)
        engine_r[dname] = ep.get_variable_data("x")["r"]
        check(launches["pl_forward_message"] == ep.n_iter > 0
              and launches["pl_backward_message"] == ep.n_iter
              and launches["pl_posterior"] == 0,
              f"relu net {dname}: launches {launches} for {ep.n_iter} "
              "sweeps (want one of each message per sweep and no "
              "five-output kernel)")
        check(gb == {"gb_posterior": 0, "gb_message": ep.n_iter},
              f"relu net {dname}: prior kernel launches {gb} for "
              f"{ep.n_iter} sweeps (want one message per sweep)")
        gb_paths[f"engine_relu_net_{dname}"] = gb
        readout = read_relu_posteriors(torch, pl, ep)
        check(readout == 2, f"relu posterior readout: {readout} launches of "
                            "the five-output kernel, want 2")
        if main_launches is None:
            main_launches, readout_launches = launches, readout
        results[dname] = (mse, v)
        print(f"relu net N=4096 {dname}: n_iter={ep.n_iter} mse={mse:.6g} "
              f"v={v:.6g} wall={wall:.3f} s sweeps/s="
              f"{ep.n_iter / wall:.1f} launches={launches}, posterior "
              f"readout: {readout} of pl_posterior [{card}]")
        # the sweep with the fused messages against the sweep as it ran
        # before the fusion, in turns
        unfused_ep = tt.ExpectationPropagation(relu_net(
            torch, tt, dtype, ReluChannel=UnfusedReluChannel)[0])
        unfused_ep.iterate(**SOLVE)
        check(unfused_ep.n_iter == ep.n_iter,
              f"relu net {dname}: {unfused_ep.n_iter} sweeps with the "
              f"unfused messages, {ep.n_iter} with the fused ones")
        for label, engine in (("fused", ep), ("unfused", unfused_ep),
                              ("fused", ep)):
            kernels, device, wall_ms = sweep_window(engine)
            print(f"relu net N=4096 {dname}, {label} messages, "
                  f"torch.profiler over 10 warm sweeps: {kernels:.1f} "
                  f"kernels per sweep, device {device:.4f} ms of "
                  f"{wall_ms:.4f} ms per sweep, busy "
                  f"{100 * device / wall_ms:.2f}% [{card}]")
    (mse32, v32), (mse64, v64) = results["float32"], results["float64"]
    v_rel, mse_rel = abs(v32 - v64) / v64, abs(mse32 - mse64) / mse64
    check(v_rel < V_MSE_BOUND and mse_rel < V_MSE_BOUND,
          f"relu net f32 vs f64: v {v_rel:.3g}, mse {mse_rel:.3g} "
          f"(bound {V_MSE_BOUND})")
    print(f"relu net f32 vs f64: v rel err {v_rel:.3e}, mse rel err "
          f"{mse_rel:.3e} (bound {V_MSE_BOUND})")

    # the card's solve (kernels) against the CPU's (plain) on a small net,
    # and the card's solve against itself
    cpu_student, x0, cpu_linear = relu_net(
        torch, tt, torch.float64, N=256, device="cpu")
    svd = (cpu_linear.U, cpu_linear.s, cpu_linear.V.T)
    gpu_student, _, _ = relu_net(torch, tt, torch.float64, N=256, svd=svd)
    cpu_ep = tt.ExpectationPropagation(cpu_student).iterate(**SOLVE)
    gpu_ep = solve(torch, tt, pl, gpu_student, x0)[0]
    card_against_cpu(torch, "relu net N=256 f64 through the engine",
                     {"x": cpu_ep.get_variable_data("x")}, cpu_ep.n_iter,
                     {"x": gpu_ep.get_variable_data("x")}, gpu_ep.n_iter,
                     ("x",))
    again = tt.ExpectationPropagation(gpu_student).iterate(**SOLVE)
    for key in ("r", "v"):
        check(torch.equal(again.get_variable_data("x")[key],
                          gpu_ep.get_variable_data("x")[key]),
              f"relu net N=256: two solves on the card differ in {key}")
    check(again.n_iter == gpu_ep.n_iter, "relu net N=256: n_iter differs "
                                         "between two solves on the card")
    print("relu net N=256 f64, two solves on the card: bit-identical x "
          "posterior")

    # phase 5: the flagship GLM, float32
    from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    N, M = 10_000, 5_000
    rng = np.random.RandomState(0)
    W = rng.randn(M, N) / np.sqrt(N)
    t0 = time.perf_counter()
    linear = LinearChannel(W, name="W", device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    svd_s = time.perf_counter() - t0
    teacher = (
        GaussBernoulliPrior(size=N, rho=RHO, device="cuda",
                            dtype=torch.float32)
        @ tt.V(id="x") @ linear @ tt.V(id="z")
        @ GaussianChannel(var=NOISE) @ tt.O(id="y")
    ).to_model()
    sample = teacher.sample(torch.Generator(device="cuda").manual_seed(1))
    student = teacher.to_observed({"y": sample["y"]})
    gb = gb_paths["engine_flagship_f32"] = {}
    ep, mse, v, wall, _ = solve(torch, tt, pl, student,
                                sample["x"].double().cpu().numpy(), gb=gb)
    check(gb == {"gb_posterior": 0, "gb_message": ep.n_iter},
          f"flagship: prior kernel launches {gb} for {ep.n_iter} sweeps "
          "(want one message per sweep)")
    check(abs(mse - v) / v < FLAGSHIP_BAND,
          f"flagship: |mse - v| / v = {abs(mse - v) / v:.3g} "
          f"(band {FLAGSHIP_BAND})")
    print(f"flagship GLM N=10000 float32: n_iter={ep.n_iter} mse={mse:.6g} "
          f"v={v:.6g} |mse-v|/v={abs(mse - v) / v:.3e} wall={wall:.3f} s "
          f"sweeps/s={ep.n_iter / wall:.1f} (SVD {svd_s:.2f} s) [{card}]")

    # phases 6 and 7: the front door, one instance and LANES lanes
    engine_launches = dict(main_launches, pl_posterior=readout_launches)
    flagship_launches, gb_paths["front_door_flagship"] = \
        front_door_flagship(torch, tt, pl, student, sample["x"], linear, v,
                            card)
    relu_launches, gb_paths["front_door_relu_net"], finish_paths = \
        front_door_relu_net(torch, tt, pl, students, engine_r["float64"],
                            card)
    check(not any(flagship_launches.values()),
          f"the flagship ran kernels: {flagship_launches}")

    # phase 9: the state evolution, float64
    phase_9a_goldens(torch, tt, card)
    phase_9b_grid(torch, tt, pl, card)
    relu_student, _, relu_linear = students["float64"]
    se_launches, relu_v_se = phase_9c_kernel_on_the_se_path(
        torch, tt, pl, relu_student, relu_linear, card)
    phase_9d_ep_against_se(torch, tt, student, v, relu_v_se,
                           results["float64"], card)

    # phase 10: the priors, likelihoods and GLMs of Queue 1 item 3
    item3_launches = phase_10(torch, tt, pl, card)

    # phase 11: the complex channels and the trees of Queue 1 items 4a, 4b
    tree_launches, tree_err = phase_11(torch, tt, pl, card)
    # phase 12: item 3's factors that no earlier phase runs
    item3_launches["item3_factors_ep_se"] = phase_12(torch, tt, pl, card)
    # phase 13: the structured channels, TV, low rank and tanh
    tree_launches.update(phase_13(torch, tt, pl, card))
    # phase 14: the engine extras and the tooling
    extras_launches, adaptive = phase_14(torch, tt, pl, students, card)
    # phase 15: the mesh
    extras_launches.update(phase_15(torch, tt, pl, students,
                                    (student, linear), card))
    # phase 16: bf16 products and state, the gated solves, pinned messages
    extras_launches.update(phase_16(torch, tt, pl, students,
                                    (student, linear), card))
    # phase 17: the gallery
    gallery_launches, tree_err["gallery_fast_paths"] = phase_17(torch, pl,
                                                                card)
    extras_launches.update(gallery_launches)
    # phase 18: the root entry points
    extras_launches.update(phase_18(torch, pl, card))

    # phase 8: summary. A main path is a solve with the posterior readout
    # that follows it: the engine's float32 relu-net solve (phase 4) and the
    # front door's relu-net solves, single and batched (phase 7); the
    # flagship's paths run no kernel. ``launches`` adds the paths up, each
    # counted from 0. The message kernels run in the sweeps, the five-output
    # kernel only in the readouts. Times at the batched main path's shape
    # (relu, float32, LANES lanes of 2048 elements): ms and plain_ms per call
    # by CUDA events, device_ms by torch.profiler; the same at one instance
    # (n = 2048) under ``one_instance``. The SE paths of phase 9c launch the
    # five-output kernel alone, twice per sweep; its times at their shapes
    # (float64, 1024 lanes of 20000 nodes and one instance's 20000) are under
    # ``se_integrand``.
    kernels = []
    for name, source in SOURCES.items():
        row = table[name, "relu", "float32", LANE_SHAPE]
        one = table[name, "relu", "float32", 2048]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "tramp_tpu/ops/pl_fused.py:81",
            "launches": (engine_launches[name] + relu_launches[name]
                         + sum(path[name] for path in se_launches.values())
                         + sum(path[name]
                               for path in item3_launches.values())
                         + sum(path[name]
                               for path in tree_launches.values())
                         + sum(path[name]
                               for path in extras_launches.values())),
            "launches_by_path": dict(
                {"engine_relu_net_f32": engine_launches[name],
                 "front_door_relu_net": relu_launches[name],
                 "front_door_flagship": 0, "se_cs_grid": 0},
                **{k: path[name] for k, path in se_launches.items()},
                **{k: path[name] for k, path in item3_launches.items()},
                **{k: path[name] for k, path in tree_launches.items()},
                **{k: path[name] for k, path in extras_launches.items()}),
            "max_abs_err": max_err[name],
            "final_state_max_abs_err": {
                path: errs[name] for path, errs in tree_err.items()
                if name in errs},
            "ms": row["per_call_ms"],
            "plain_ms": lanes_plain_ms[name], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "device_ms": row["device_ms"], "host_ms": row["host_ms"],
            "shape": list(LANE_SHAPE),
            "one_instance": {
                "ms": one["per_call_ms"], "plain_ms": plain_ms[name],
                "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
                "device_ms": one["device_ms"], "host_ms": one["host_ms"]}})
        if name == "pl_posterior":
            sweep = adaptive["float32"]
            bound, by, _ = bound_ms(name, relu.region_specs, sweep["n"],
                                    torch.float32)
            kernels[-1]["adaptive_ep_sweep"] = {
                "n": sweep["n"], "dtype": "float32",
                "launches_per_sweep": sweep["launches_per_sweep"],
                "device_ms_per_sweep": sweep["pl_posterior_device_ms"],
                "bound_ms_per_sweep": sweep["launches_per_sweep"] * bound,
                "bound_by": by,
                "sweep_wall_ms": sweep["wall_ms"],
                "sweep_device_ms": sweep["device_ms"]}
            kernels[-1]["se_integrand"] = {
                str(shape): {"ms": row["per_call_ms"],
                             "plain_ms": row["plain_ms"],
                             "bound_ms": row["bound_ms"],
                             "bound_by": row["bound_by"],
                             "device_ms": row["device_ms"],
                             "host_ms": row["host_ms"]}
                for shape, row in se_rows.items()}
        check(kernels[-1]["launches"] > 0, f"{name} was never launched on "
                                           "the main paths")
    # The Gauss-Bernoulli prior's kernel (no TPU kernel: the JAX package
    # leaves the prior to XLA): its launches on the main paths of phases 4
    # to 7 that run it, each counted from 0, and phase 3's readings at the
    # cell's shape in float64 (GB_MAIN), every shape and type under
    # ``cases``.
    for name, shape in GB_MAIN.items():
        main_case = gb_cases[name][(*shape, "float64")]
        by_path = {path: counts[name] for path, counts in gb_paths.items()}
        kernels.append(dict(
            {"name": name, "route": "cuda",
             "source": "tramp_tpu_torch/csrc/gb_prior.cu", "replaces": None,
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": max(case["max_abs_err"]
                                for case in gb_cases[name].values())},
            **{key: main_case[key]
               for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                           "device_ms", "host_ms", "shape", "dtype")},
            cases=list(gb_cases[name].values())))
        check(kernels[-1]["launches"] > 0, f"{name} was never launched on "
                                           "the main paths")
    # ML-VAMP's loop finish (no TPU kernel: XLA fuses the chain in the JAX
    # package's while_loop): its launches on phase 7's MLVAMPSolver paths,
    # one per loop iteration, and phase 3's readings at the relu cell's
    # shape in float64, every case under ``cases``.
    main_case = finish_cases["float64", LANES]
    kernels.append(dict(
        {"name": "ml_vamp_finish", "route": "cuda",
         "source": "tramp_tpu_torch/csrc/ml_vamp_finish.cu",
         "replaces": None, "launches": sum(finish_paths.values()),
         "launches_by_path": finish_paths,
         "max_abs_err": max(case["max_abs_err"]
                            for case in finish_cases.values())},
        **{key: main_case[key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                       "device_ms", "host_ms", "shape", "dtype")},
        cases=list(finish_cases.values())))
    check(kernels[-1]["launches"] > 0, "ml_vamp_finish was never launched "
                                       "on the main paths")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--nccl-rank"]:
        nccl_worker(sys.argv[2:])
    else:
        main()
