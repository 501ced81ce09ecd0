"""Smoke run of the PyTorch/CUDA port (rlvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

1. ``device``: the card's name, count, and ``nvidia-smi`` name and power limit.
2. ``build``: one ``nvcc`` per ``rlvae_tpu_torch/csrc/*.cu``, all started
   together, then one link; the ``-Xptxas -v`` lines of every kernel.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the shapes the serving and training paths give it, with the tolerance
   stated; ms per launch from CUDA events around back-to-back wrapper calls
   (``ms``, host issue time included where the host is the slower), and
   device ms per launch from a CUDA graph of GRAPH_LAUNCHES launches,
   replayed (``device_ms``).  The IAF-chain forward (B = 1, 7,
   16, 64) and backward (B = 1, 16, 64) are held to their plain versions at
   the near-identity flow init and, at the model's reference init, to an
   fp64 evaluation, in both instantiations (weights resident in shared
   memory, and streamed), bit-identical on relaunch; each batch prints the
   launcher's cluster geometry.  The chol-bundle is held to its plain
   version, and the metric bundle and G^{-1} to theirs and to an fp64
   evaluation, at K=50, 200 and 20 000 and B=1, 7, 64 and 1000, each case
   printing its launch geometry, bit-identical in a graph replay at B=64;
   the HMC terms likewise at B=1, 37, 64, 1000, 50 and 4096 (the adaptive
   sampler's calibration chains and warm-start pool) and on a K=37 bank
   padded to 40 (every geometry their rule picks), bit-identical on relaunch and
   in a graph replay; rows far from every centroid.  The decode+MSE forward, dh and dW/db are held to
   their plain versions (the forward's loss also to fp64) at M=128 (the fast
   train step's B=16), 512 and 37 rows, N=12288 and 300, on the pretrained
   decoder's weights, bit-identical on relaunch and in a CUDA-graph replay;
   each is timed at M=128 and 512, warm (``device_ms``) and cold (each
   launch after a 256 MB write that evicts the L2, the write's own time
   subtracted: ``cold_ms``), beside cuBLAS's time for the entry point's
   last bf16 product alone.  The HMC partials (one shard's
   G^{-1} sum and gradient contraction) are held to their plain version and
   to fp64 at K=50, 200, 20 000 and 37 padded to 40, B=64, 37, 1 and 1000,
   bit-identical on relaunch and in a graph replay, with the geometry of
   each case.  The IAF-chain kernels' Jacobi mode (``fp_iters`` K = 2, 8,
   15; the backward at K + 1 sweeps) at B = 16 and 64 in both
   instantiations against the plain versions and fp64, bit-identical on
   relaunch and in a graph replay, K = 15 = D - 1 against the sequential
   kernel (within fp32 rounding: layer 0 is a full product there), timed at
   B=64 beside the sequential mode with the dependent layer steps.  The
   IAF-chain backward's sequential mode (``n_sweeps = 0``, JAX's
   ``adj_sweeps = 0``) at B = 1, 16, 37 and 64 in both instantiations
   against its plain version (near-identity init) and fp64 (reference
   init), bit-identical on relaunch and in a graph replay, at B=64 against
   the adjoint mode after the MADE masks, and timed beside the adjoint mode.
4. ``serve``: ``ModelManager.from_config(PRESETS["riemannian_flow_vae"])`` on
   the card behind a ``BatchingEngine``; 64 ``reconstruct`` requests from 8
   threads plus 16 ``encode`` and 16 ``decode``, after one warm-up call per
   (op, bucket).  The launch counters are zeroed just before the requests
   and read just after; one B=64 forward on the card is held against the
   same model moved to the CPU, and one is profiled.
5. ``train``: ``Trainer`` takes 5 Adam steps of the full-width preset at
   B=16 on synthetic sequences (training preset ``default``).  The launch
   counters are zeroed just before ``fit`` and read just after, and read
   around every step (chol-bundle 2, IAF-chain forward 1, backward 1); the
   validation pass reports the six analysis metrics and launches G^{-1}.  Each
   card step is replayed on the CPU from the card's weights and optimizer
   state just before it, with the same batch and noise: the losses are
   gated, grad_norm and the step-1 gradients reported (at the reference
   flow init they are ill-conditioned), and the card's step-1 gradients
   held to an fp64 step on the CPU no less closely than the CPU's.  Then
   GRAD_WITNESS_STEPS steps of the same path at the near-identity flow
   init (``flow_log_var_bias_init: 0``), replayed with the losses,
   grad_norm and step-1 gradients gated.  The posterior, fast, fixedpoint
   and seq_bwd phases replay their ``Trainer`` steps the same way.  One
   warm step is timed with CUDA events and one is profiled.
6. ``generate``: a full-width ``ModelManager`` on the card generates through
   ``sample_random_batched_seeds`` at B=1 and B=64 with the ``geodesic``
   prior and the ``official`` manifold-HMC chain, and at B=64 with the other
   prior methods and the ``hmc`` chain.  The launch counters are zeroed just
   before and read just after, and around each call (1601 ``hmc_terms``
   launches per chain).  One ``official`` call is profiled.  A chain of
   GEN_REPLAY_STEPS (25 of the official chain's 100) MCMC steps
   on the official chain's draws is stepped on the card, held to
   ``run_prior_chain``'s, and each step replayed on the CPU from the card's
   state before it with the same noise; one geodesic batch is decoded on
   the card and on the CPU from the same draws.  Then an engine with
   ``generate_method="official"`` answers concurrent seeds [7, 123, 7, 999]
   and a lone request, each row against ``sample_random(1, seed)``.
7. ``posterior``: ``PRESETS["hybrid_rlvae"]`` (Gaussian posterior, K=200
   metric at T=0.7) with ``sampling.method: geodesic`` behind a
   ``BatchingEngine``: 64 ``reconstruct`` requests in one B=64 bucket, one
   metric-bundle launch per forward; host-clock and device time of a warm
   B=64 forward, which is held against the CPU on the same noise.  Then 3
   ``Trainer`` steps of the geodesic model at B=16, each replayed on the CPU
   as in the train phase, with a validation pass that launches G^{-1}.  Then
   the shipped ``hybrid_rlvae`` (``enhanced``) reconstructs once.
8. ``fast``: ``PRESETS["riemannian_flow_vae_fast"]`` (sampling-direction
   flows, fused decode+MSE loss): 5 ``Trainer`` steps at B=16 as in the
   train phase (per step: chol-bundle 2, ``decode_mse`` forward, dh and
   dW/db 1 each, no IAF-chain launch), each replayed on the CPU, with a
   validation pass; then one warm B=64 ``reconstruct`` bucket behind a
   ``BatchingEngine`` (chol-bundle 2, nothing else) and a B=64 forward held
   against the CPU.
9. ``ep``: the centroid-sharded (expert-parallel) HMC path of
   ``rlvae_tpu_torch.parallel`` in one process on the 1 x 1 mesh, on the
   default model's K=50 metric at T=3.0.  ``hmc_terms_sharded`` is held
   against ``hmc_terms`` at K=50 and 20 000, and the bank split into 4
   padded shards (``hmc_partials`` on each, summed in shard order, then the
   epilogue) against the whole bank.  ``sample_prior_hmc_sharded`` runs the
   official chain (100 x 15) at B=64 with the counters zeroed just before
   and read just after (1601 ``hmc_partials`` launches, no ``hmc_terms``);
   host-clock time, and the busy share of a profiled 2-step chain.
   ``chol_g_inv_sharded`` at B=64 launches the G^{-1} kernel once and is
   held to the dense chol-bundle factor.  A chain of EP_REPLAY_STEPS (5)
   MCMC steps on the same draws is stepped one step at a time and held to
   the entry point's, each step replayed on the CPU from the card's state,
   and each also taken with the dense ``hmc_terms`` from the same state.
10. ``dense_chain``: the official chain (100 x 15) at B=64 through
   ``sample_prior_hmc`` on the K=20 000 synthetic bank, where B4 sets the
   wall time: host seconds with the counters zeroed just before and read
   just after (1601 ``hmc_terms``), the profiled device time and busy share
   of a second run, and the first DENSE_REPLAY_STEPS MCMC steps replayed on
   the CPU from the card's state (also with every proposal accepted, so
   that the leapfrog endpoints are compared where the chain rejects).
11. ``checkpoint``: save, resume and reload the full-width default model in
   a temporary run directory outside the tree.  A ``Trainer`` at B=16 (5
   steps an epoch) is stopped by ``stop_flag`` after epoch 0 (``preempted``,
   ``best`` and ``last`` written); ``last`` restored on the card and with
   ``map_location="cpu"`` gives the live weights and Adam state bit for bit;
   a fresh ``Trainer`` (other seeded flows) with ``fit(resume=True)`` starts
   from exactly that state and runs epochs 1 and 2 (steps 6-15, the best
   validation loss no worse, the learning rate and Adam step counts carried),
   and ``evaluate()`` reads ``best`` without touching the live weights.  Then
   ``ModelManager.from_checkpoint(run_dir, preset, "best")`` on the card
   behind a ``BatchingEngine``: a B=64 ``reconstruct`` bit for bit equal to a
   model loaded from the slot by hand, the engine's 64 rows (one batch)
   equal to it, and a B=64 forward replayed on the CPU from the same slot
   and noise (``compare_trained_forward``: the bf16 encoder layer by layer
   from the card's inputs, the rest from the card's encodings, within
   ``compare_forward``'s tolerances).  Seconds and bytes of
   every save and restore; the counters are zeroed just before the first
   ``fit`` and read after the CPU replay (chol-bundle, IAF-chain forward and
   backward, G^{-1}).
12. ``adaptive``: ``BatchingEngine.from_manager(ModelManager.from_config(
   PRESETS["riemannian_flow_vae"]), generate_method="adaptive")``.  The
   manager's ``adaptive_plan`` calibrates with a 4096-entry pool (the
   counters zeroed just before): B4 launches per chain run, 1 + 40 x 6 and
   1 + 13 (n_lf + 1) at B=50, 1 + 128 (n_lf + 1) at B=4096; host seconds,
   and a second calibration on the same draws profiled (device time, busy
   share) and equal to the plan bit for bit.  64 ``generate`` requests from
   8 threads, one seed each, after a warm-up: 1 + 12 (n_lf + 1) B4 launches
   and one IAF-chain launch per batch; host ms of a B=64 batch, planned
   and official, in turns.  The planned chain of one batch and
   POOL_REPLAY_ROWS (16) of the pool's rows (all 128 steps from their
   centroid starts) replayed step by step on the CPU from the card's state.  ``sample_random(64, "adaptive")``
   (the budget sampler): its launches against its n_lf and steps, the first
   3 MCMC steps of its phase A replayed on the CPU.  ``estimate_nll`` at
   B=16, S=50 (one chol-bundle and 50 IAF-chain launches) against the CPU:
   every sample's log w and the NLL, without the Gaussian's constant.
   One B=64 ``reconstruct`` bucket of ``hybrid_rlvae`` with ``sampling.method:
   hmc`` (200 B4 launches at K=200) on frames decoded from the metric's
   centroids; the encoder on them against the CPU; each of the posterior
   chain's 20 steps replayed on the CPU from the card's state (also for
   uniform-noise frames, whose chain diverges, in JAX as here), then the
   rest of the forward from the card's encoder output and z0.
   ``interpolate`` (linear, spherical, 10 steps) against the CPU between
   the card's embeddings, the encoder held to the CPU as well.
13. ``experiment``: ``rlvae_tpu_torch.experiment.main`` (``python -m
   rlvae_tpu_torch.experiment``) over ``conf/``, in temporary run
   directories, at full width, cut in epochs and sequences (32 train, 8
   validation, 16 test): ``model=riemannian_flow_vae training=quick`` for 2
   epochs with ``training.trainer.profile=true`` (its files, chol-bundle 2
   and IAF-chain forward and backward 1 per train step, chol-bundle 3,
   IAF-chain forward 1 and G^{-1} 1 per evaluation batch, StepTimer keys in
   every step record, the epoch-0 trace naming the IAF-chain kernels; the
   visualization level ``full``: where matplotlib is missing, as on the
   card's box, one ``viz/error`` naming it per due module, 5 in all, after
   the interactive module's forward and two sliders; where it imports,
   none), then
   ``ModelManager.from_run`` on its directory, a B=64 forward on the card
   against the CPU (``compare_trained_forward``);
   ``experiment=comparison_study`` (``vanilla_vae`` launches nothing); ``-m model=hybrid_rlvae
   model.sampling.method=enhanced,geodesic`` (the metric bundle once per
   train step and evaluation batch in the ``geodesic`` job, never in the
   ``enhanced`` one); one ``model=riemannian_flow_vae_fast`` epoch (the
   decode+MSE kernels once each per train step).  The counters are zeroed
   before the first run and read after the last.  Every run's training
   batches come from the native C++ loader (``data.use_native_loader``,
   JAX's default; its epochs counted), built with g++ on the card's host;
   a data module as the single run's gives each epoch's batches as a
   permutation of its training rows, the same twice for one seed.
14. ``convnets``: ``conf/model/cnn_rlvae.yaml``, ``resnet_rlvae.yaml`` and
   ``mlp_rlvae.yaml`` composed from ``conf/`` at their published widths
   (64x64 frames, 8 flows; their MLP artifacts do not fit, so the nets keep
   their seeded init, as in JAX), with dropout 0.1 and BatchNorm.  For each:
   CONVNET_STEPS ``Trainer`` steps at B=16 (synthetic sprites, 8 frames)
   with one validation batch; per step chol-bundle 2, IAF-chain forward and
   backward 1 each, no decode+MSE; G^{-1} once in the validation; the
   running statistics all moved.  Each step is replayed on the CPU from the
   card's state with the same batch, noise and dropout masks (the card's
   ``DropoutMasks`` recorded): every loss term and the statistics after it
   held to CONVNET_REPLAY_TOL (grad_norm and the nets' step-1 gradients
   reported: at the reference flow init they are not reproducible across
   devices).  One warm step's host ms, CUDA-event ms, profiled device time
   and busy share, split into the ported kernels, cuDNN convolutions,
   reductions, elementwise kernels and products.  Then ``ModelManager.from_run`` on the
   run (``best`` bit for bit) behind a ``BatchingEngine`` with
   ``generate_method="official"``: 64 requests of each of ``reconstruct``
   (chol-bundle 2, IAF-chain forward 1), ``encode``, ``decode`` (none) and
   ``generate`` (1601 HMC-terms launches, IAF-chain forward 1), each in one
   bucket, and a B=CONVNET_CMP_BATCH forward held to the CPU within
   CONVNET_E2E_TOL (the reconstruction on frame 0, CONVNET_RECON0_TOL;
   ``mlp_rlvae``'s bf16 encoder through ``compare_trained_forward``).
   Last, one fp32-policy ``cnn_rlvae`` run at the near-identity flow init
   replayed on the CPU at 1e-4, grad_norm included, and the encoder's and
   decoder's step-1 gradients at 1e-3.

15. ``geometry``: the latent geometry and RHVAE metric pre-training.  On
   the default model at full width (``PRESETS["riemannian_flow_vae"]``,
   K=50 metric at T=3.0, D=16): ``interpolate(x1, x2, 10,
   mode="geodesic")`` (200 metric-bundle launches, one per Adam step; the
   latent path replayed on the CPU from the card's embeddings, held by
   its points and by its energy against the band of the CPU's last 20
   iterates; host ms per Adam step warm, profiled device ms per step and
   busy share);
   ``sample_latent(64, "geodesic_exact")`` (80 metric-bundle launches and
   one G^{-1}) and a 64-request ``generate`` bucket of an engine with
   ``generate_method="geodesic_exact"`` (one dispatch, plus one IAF-chain
   launch, equal to a direct ``sample_random_batched_seeds``), both
   replayed on the CPU from the card's draws; on 64 centroid-to-centroid
   pairs the Christoffel symbols (one launch), ``exp_map`` (32 RK4 steps,
   one launch per stage), ``log_map`` and ``geodesic_interpolate(method=
   "shooting")`` (GEO_SHOOT; their launches counted), each against the
   CPU (log_map and the shooting path on GEO_LOG_REPLAY_ROWS rows); the
   Gaussian curvature on a 32 x 32 grid of the centroids' PCA plane (the
   plain path, no launch) against the CPU.  Then ``train_metric`` of the
   RHVAE at the published widths (3x64x64, latent 16, batch 64, 3 leapfrog
   and 3 fixed-point steps), warm-started from the pretrained encoder and
   decoder, RHVAE_STEPS (2) steps on synthetic sprites frames (16 G^{-1} launches per
   step), each step replayed on the CPU from the card's weights and draws
   (loss and gradient norm at the train phase's tolerances); one more
   step's host ms and CUDA-event ms.  The consolidated K=128 metric is saved and loaded
   through ``save_metric``/``load_metric``, held to the plain versions of
   the chol-bundle, metric bundle, G^{-1} and HMC terms, and swapped into
   the default model behind an engine: one 64-request ``reconstruct``
   bucket (chol-bundle 2, IAF-chain forward 1) and one ``official``
   ``generate`` bucket (1601 HMC-terms launches, IAF-chain forward 1).
16. ``dp``: data parallelism through ``python -m
   rlvae_tpu_torch.parallel.dp_verify`` (its ranks are subprocesses; each
   zeroes and reads its own launch counters around every step): the
   default preset at full width, global B=16, DP_STEPS (1) DP step in an
   NCCL world of one rank (equal to the plain trainer bit for bit) and in a
   gloo world of two ranks sharing ``cuda:0`` (NCCL refuses that) in the
   2 x 1 and 1 x 2 (DP x TP) layouts, each with a 3-step epoch on
   DP_TRAIN_ROWS (48) sequences and a resume, plus a ``cnn_rlvae`` step on
   2 x 1 and a step of the fast preset on 1 x 2 (its decoder's output layer gathered for the fused
   kernel); per rank and step chol-bundle 2, IAF-chain forward and
   backward 1 (the fast preset: chol-bundle 2, each decode+MSE kernel 1,
   no IAF chain); every step replayed in one process on the card (loss,
   step 1's grad_norm, Adam's first moment and the update leaf by leaf, at
   ``dp_verify.CARD_TOL``), the epoch's rows against ``host_epoch_perm``,
   the BatchNorm statistics against the shards' mean, the all-reduce's
   count and bytes against ``comm_audit.step_plan``.  The step's host ms,
   the all-reduce's ms and share, and the busy share per rank; the
   ``kernels`` line's ``launches_per_dp_train_step_per_rank`` are the
   counts of rank 0's first step of each layout.  Then
   ``BatchingEngine.from_manager(..., devices=["cuda:0", "cuda:0"])``: one
   bucket of 3 of each op (``generate`` geodesic), every row against the
   one-device manager's.
17. ``fixedpoint``: ``PRESETS["riemannian_flow_vae"]`` with
   ``flow_fixedpoint_iters: 8``: 5 Trainer steps at B=16 (chol-bundle 2,
   the IAF-chain forward in the Jacobi mode and its backward at 9 sweeps,
   1 each), each replayed on the CPU's plain Jacobi chain, and the
   validation pass (G^{-1}); one B=64 ``reconstruct`` bucket (chol-bundle
   2, IAF-chain forward 1), a B=64 forward against the CPU and the card's
   chain against the CPU's from the card's own z0; ``fixedpoint_error`` at
   K=8 per transition and the two modes' chains, reported, not gated.
18. ``research``: ``LVAE_IAF``, ``RIEM`` (the K=50 metric at T=3.0) and
   ``LVAE_GUGUS`` (``lvaegg``, its Riemannian prior on) at their published
   widths (3x64x64, latent 16, 8 visits, MLP nets 12288->512->16): 3 Adam
   steps at B=16 each (a warmup step, then the visit branch at the first
   visit and a later one), each replayed on the CPU from the card's state
   on the same draws; GUGUS estimates its local metrics on the card first.
   Each generates 16 sequences against the CPU on the same draws (GUGUS by
   manifold HMC on its one-centroid metric: 321 HMC-terms launches, B4 at
   K=1, which is also held to its plain version and fp64 and timed).  RIEM
   launches the chol-bundle (its rejection sampler's volumes and boundary
   prior) and the metric bundle (its metric step); the flow models' IAFs
   run as plain ops, as in JAX.  ``lvaega``'s training draw, which autograd
   would differentiate through B4, raises.  ``VAMP`` (50 pseudo-inputs) and
   ``GPVAE`` (Cauchy prior over 8 visits) likewise take 3 Adam steps each,
   replayed on the CPU, and generate 16 rows (VAMP's through
   ``VampSampler``), launching nothing of the port.  ``LLDM`` at JAX's
   defaults (3x64x64, latent 12, 8 visits, MLP nets, the posterior IAF, the
   standard prior, eps-net hidden 128): its eps-net pre-trained
   LLDM_PRETRAIN steps on the card's encodings (the first step
   replayed on the CPU), the sampled metric of 16 centroids from the data
   end's encodings attached, 3 Adam steps at B=16 and LLDM_LR (the warmup
   branch, the first visit, the last visit against the metric's volume)
   replayed on the CPU; ``reconstruct``, ``oversample``, ``predict``, ``get_nll`` and a
   16-sequence ``generate`` (HMC 100 x 10) against the CPU on the same
   draws, the CPU's metric built from the card's encodings; no kernel
   launched.  Then ``python -m rlvae_tpu_torch.research_cli`` trains each
   of the six models for 2 epochs on the card (RESEARCH_CLI_ARGS), finite
   losses, MSE and NLL (LLDM has no NLL estimate, as in JAX).
19. ``seq_bwd``: ``PRESETS["riemannian_flow_vae"]`` with
   ``iaf_kernels.ADJ_SWEEPS_OVERRIDE = 0``: 3 Trainer steps at B=16
   (chol-bundle 2, IAF-chain forward 1, backward 1 in its sequential mode,
   which ``iaf_chain_bwd.sequential_launches`` counts: every backward
   launch of the run, and none in the paths before it), each replayed on
   the CPU under the same override (its plain sequential backward) at
   TRAIN_TOL, the validation pass (G^{-1}); one batch's gradients in the
   two modes against each other (JAX's ``grad_probe`` deviation,
   SEQ_GRAD_TOL).
20. ``deploy``: the deployment surface on the default model at full width
   (pretrained nets, K=50 metric).  ``export_model`` traces
   ``reconstruct``, ``encode``, ``decode`` and ``generate`` (geodesic
   prior) at buckets 1 and 64 with ``torch.export`` (the chol-bundle, IAF
   chain and G^{-1} as registered ops: counted in each graph) and
   ``load_exported`` loads them on the card.  The counters are zeroed, then
   every program runs at a full bucket of 64 and of 1 and a padded bucket
   (3 rows), and one request per op goes through ``bundle_server`` over
   HTTP: B1 2 and B2 1 per ``reconstruct``, B7 1 and B2 1 per
   ``generate``.  Each output is held bit for bit to the live manager's on
   the same inputs and draws (the same kernels), the HTTP rows to the
   bundle's; each B=64 program is profiled beside its eager op, the same
   kernels by name and count; B=64 bundle and eager latencies on the host
   clock.  ``app_server`` over a run directory of the same weights answers
   one ``reconstruct`` and one ``generate`` (the live manager's row); where
   matplotlib imports, ``app.build_report`` renders the dashboard.  Then
   ``run_deploy_methods``: ``generate`` exported by every other prior
   method JAX's ``export_model`` exports (``weighted_mixture``,
   ``geodesic_exact``, ``basic``, and the ``official`` and ``hmc`` chains,
   each one ``while_loop`` op with B4's registered op in its body) and the
   hybrid model's ``reconstruct`` with the ``hmc`` posterior, at buckets 1
   and 4; the registered ops of each graph counted; with the counters
   zeroed, each program at a full bucket of 4 and a padded 3 bit for bit
   against the live manager, every call's launches the eager call's
   (1601 B4 a chain, 200 a posterior chain); export and load seconds,
   program bytes and B=4 host ms beside the manager's.
21. ``viz``: the visualization modules, the flow zoo and the slope timers.
   The default model at full width (pretrained nets, K=50 metric at T=3.0),
   ``conf/visualization/full.yaml`` (level FULL, curvature, fancy plots),
   VIZ_SEQS (8) synthetic sequences of 8 x 3 x 64 x 64.  The shared forward
   on the card gives the latents; from them each module's fields are
   computed on the card and on the CPU and held to VIZ_TOL field by field:
   ``manifold`` (log sqrt det G^{-1} on a 60 x 60 grid and along the
   trajectories, B1; G^{-1}, B7; the 30 x 30 curvature, plain ops),
   ``flow_analysis`` (the flows' Jacobian spectra by ``jacfwd``, plain ops;
   log sqrt det and log det G^{-1}, B1), ``interactive`` (9 decoded
   latents; six temperatures on a 40 x 40 grid, a 30 x 30 field, a 50 x 50
   field and the dense paths, B1; G on 12 x 12, ``dist2`` on the
   transitions and 2 500 probes, the energy path at 16 points over 120 Adam
   steps and ``path_length``, B6; a 24 x 24 curvature; ``generate(4)`` on
   the geodesic prior, B7 and B2), each module's host seconds and launches
   by the counters; ``basic`` is the forward's host statistics.  Then the
   manager at FULL through the trainer's hook (``make_viz_hook``) on the
   card at epoch 0: where matplotlib is missing each module gives one
   ``viz/error`` naming it and ``interactive`` leaves its two sliders (its
   forward launching B1 2 and B2 1); where it imports, every artifact of
   tests/test_viz.py.  The flow zoo at D=16, B=64 card vs CPU (MAF both
   ways and its round trip, planar, radial, the flow BatchNorm in train and
   eval with its inverse, ZOO_TOL); PixelCNN at the reference defaults
   (1x28x28, 10 layers, 64 channels, 256 embeddings): logits and loss at
   B=16 against the CPU, one 784-step ``pixelcnn_sample`` of 4 images on the
   card from passed Gumbel noise, the logits at PCNN_CHECK_STEPS recomputed
   on the CPU from the card's partial image (the card's choice the CPU's
   argmax, ties within PCNN_TIE counted); the slope timers on B1 (K=50,
   B=64): ``scan_slope_time`` over 64 distinct batches in one CUDA graph and
   ``fori_slope_time`` on one captured launch, reported beside the kernels
   phase's ``device_ms``, gated on structure only.
22. ``latent_dims``: every latent width the JAX package runs.  B1, B4, B6,
   B7 and B8 at D = 1, 2, 5, 8, 12, 16, 24, 31, 32 (D <= 16 on the kernels'
   width-16 instances, 17..32 on the width-32 ones, a zero-padded bank
   where D is neither), K = 1, 50, 200 and B = 1, 64, and at D = 32, K =
   20 000, B = 64: each against its plain version and fp64 at the kernels
   phase's tolerances, its structure, bit-identical on relaunch and in a
   CUDA-graph replay; at D = 32, B = 64, K = 50 and 20 000 device ms beside
   the plain version and the bound.  Then the slice's path at latent 32,
   each part counted from zero and ``plain_route.calls`` held at 0: the
   components CLI (``--latent-dim 32``, cut to 16 sequences and one epoch
   of each stage; G^{-1} 16 times a RHVAE step, each step replayed on the
   CPU) writes a 32-D bank; the default preset on it (full widths; the
   shipped 16-D nets refused with a warning, the seeded init kept; the
   flows near the identity but in the reference-init run) serves a B=64
   reconstruct bucket (B1 2, B2 1; a B=64 forward vs the CPU), takes 3
   Trainer steps at B=16 (each replayed on the CPU with the gradients
   gated) and generates with ``official`` and
   ``hmc`` at B=64 (1601 B4 a chain; the official chain's 100 steps
   stepped on the card, the first 10 and each step that accepted a row
   replayed on the CPU); the same preset at its reference flow init runs a
   B=64 forward, card and CPU each held to an fp64 forward, and one Trainer
   step replayed on the CPU with its gradients held to fp64's; the geodesic
   hybrid at latent 32 serves a bucket (B6, B2) and takes a replayed step;
   the EP chain at B=64, 80 MCMC steps
   (1281 B8), stepped and replayed on the CPU as the official chain's, and
   against dense B4; the
   ``reconstruct`` program exported at bucket 4, bit for bit the live
   manager.  Then a latent-48 model (past the kernels' envelope): a B=64
   forward and a ``geodesic`` generate launch no kernel and take the plain
   route, against the CPU; and an IAF chain at H = 512 on the plain route,
   against the CPU.  Then B5 past 512 hidden units (``csrc/decode_mse_wide.cu``)
   at K = 1024, M = 128 and 37, N = 12288 and 300, against its plain versions
   (and fp64) bitwise on relaunch and in a graph replay, timed beside the
   bound; and 2 Trainer steps of ``mlp_rlvae`` (decoder [256, 512, 1024])
   with ``fused_decode_mse=true`` and dropout 0 in both nets, each step B1
   2, B2 1, B3 1 and the three B5 entry points, replayed on the CPU.

Each phase's record carries its own seconds (``phase_s``); a
``phase_seconds`` line lists them all.  Then a ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
run exits non-zero; a hang dumps every thread's stack and exits.  Without a
CUDA card the run fails at once.
"""

from __future__ import annotations

import contextlib
import copy
import faulthandler
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

PRETRAINED = Path(__file__).resolve().parent / "data" / "pretrained"
# the whole run's hang guard: under the run's 1200 s limit, with room for a
# host 1.6x slower than one on which the script took 650 s
HANG_GUARD_S = 1080
SERVE_BATCH = 64  # the engine's largest bucket: the main path's batch
# the adaptive sampler's calibration: one chain per centroid of the K=50
# metric, and the manager's warm-start pool
ADAPTIVE_CHAINS, ADAPTIVE_POOL = 50, 4096
N_RECONSTRUCT, N_THREADS, N_ENCODE, N_DECODE = 64, 8, 16, 16
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# dense bf16 on the tensor cores: the bound of decode+MSE's products
PEAK_BF16_TENSOR_FLOPS = 989e12
# kernel vs plain version, both fp32 on the card, summed in another order;
# the factorization amplifies G^{-1} rounding by up to its condition number
CHOL_RTOL, CHOL_ATOL = 1e-4, 1e-5
# IAF chain: |kernel - plain| <= IAF_RTOL * (largest |z| of that transition);
# at the reference init, the kernel's error against fp64 is at most
# IAF_FP64_FACTOR times the plain fp32 version's (or within IAF_RTOL)
IAF_RTOL = 1e-4
IAF_FP64_FACTOR = 4.0
# the training path's batch, and the batches the backward kernel is timed at
TRAIN_BATCH, TRAIN_STEPS = 16, 5
BWD_BATCHES = (1, TRAIN_BATCH, SERVE_BATCH)
N_TRANSITIONS = 7  # 8 frames -> 7 transitions
# HMC terms: log pi within HMC_LP_ATOL and grad within HMC_RTOL of its
# largest entry, kernel vs plain fp32; against fp64, the kernel's error at
# most IAF_FP64_FACTOR times the plain fp32 version's (or HMC_RTOL of scale):
# the gradient goes through an inverse of G^{-1}
HMC_LP_ATOL, HMC_RTOL = 1e-5, 1e-4
HMC_BATCHES = (1, ADAPTIVE_CHAINS, SERVE_BATCH, 1000, ADAPTIVE_POOL)
# the metric kernels B1, B6 and B7: one row, a ragged batch, the serving
# bucket and a large batch (rows blocked 8 a CTA)
METRIC_BATCHES = (1, 7, SERVE_BATCH, 1000)
# the HMC terms and partials at every geometry their rule picks for K = 50,
# 200 and 20 000 (csrc/hmc_bank.cuh: rows blocked 1, 2, 4 or 8 a CTA; the cluster
# size the largest, up to 8, whose clusters the card holds in one wave, e.g.
# 6 at B=64, K=20 000 on the H100); the HMC terms also at the adaptive
# sampler's calibration chains (one per centroid, B=50) and warm-start pool
# (B=4096: 512 CTAs of 8 rows, the K=20 000 cluster cut to 1)
HMC_KERNEL_BATCHES = (1, 37, SERVE_BATCH, 1000, ADAPTIVE_CHAINS, ADAPTIVE_POOL)
# device time per launch: this many launches captured in one CUDA graph
GRAPH_LAUNCHES = 20
# generation: the batches of sample_random_batched_seeds, the chain's launches
GEN_BATCHES = (1, SERVE_BATCH)
CHAIN_LAUNCHES = 1 + 100 * (15 + 1)
# MCMC steps of the official chain stepped on the card and replayed on the
# CPU (all 100 until the viz phase joined the run: its time budget)
GEN_REPLAY_STEPS = 25
# card chain vs its CPU replay, per MCMC step from the card's state: z within
# CHAIN_Z_RTOL of max(1, |z|) (15 fp32 leapfrog steps); the accept decision
# identical unless |u - alpha| < ACCEPT_MARGIN (alpha is exp of a difference
# of fp32 sums, which the two devices round apart)
CHAIN_Z_RTOL, ACCEPT_MARGIN = 1e-4, 1e-3
SERVE_SEEDS = (7, 123, 7, 999)
# metric bundle and G^{-1}, kernel vs plain fp32 (the JAX package's kernel
# tolerances: G^{-1}, L, logdet, G); against fp64, each output's error at most
# BUNDLE_FP64_FACTOR times the plain fp32 version's, or BUNDLE_FP64_RTOL of
# the output's scale
BUNDLE_TOL = {"g_inv": (1e-5, 1e-6), "l": (1e-4, 1e-4), "logdet": (1e-4, 1e-4),
              "g": (1e-3, 1e-3)}
BUNDLE_FP64_FACTOR, BUNDLE_FP64_RTOL = 2.0, 1e-5
# the posterior phase: Trainer steps of the geodesic hybrid model
POSTERIOR_TRAIN_STEPS = 3
# decode+MSE: the kernel vs its plain version on the card, the loss rtol and
# each gradient's error relative to its largest entry (a bf16 rounding of dp
# may flip where the fp32 pre-activation is summed in another order; dh as
# its fp32 sum, from an fp32 h); the bf16 dh of a bf16 h within one bf16 step
# (2^-7) of each element on top of that (its final rounding flips where the
# fp32 sum, taken in another order, lies near a tie); vs an fp64 evaluation
# of the same bf16 operands, the loss's error at most DECODE_FP64_FACTOR
# times the plain fp32 version's, or DECODE_FP64_RTOL
DECODE_LOSS_RTOL, DECODE_GRAD_RTOL = 1e-5, 1e-3
DECODE_FP64_FACTOR, DECODE_FP64_RTOL = 2.0, 1e-6
DECODE_ROWS = (TRAIN_BATCH * 8, 512, 37)  # B*T rows: the fast train step's, a larger, a ragged
DECODE_COLS = (12288, 300)
DECODE_TIMED_ROWS = (TRAIN_BATCH * 8, 512)
DECODE_FLUSH_BYTES = 256 << 20  # written between cold launches: 5x the H100's 50 MB L2
# HMC partials, kernel vs plain fp32: gi_part and v within these multiples of
# max(1, |plain|) elementwise (sums over K in another order); against fp64,
# the kernel's error at most IAF_FP64_FACTOR times the plain version's, or
# PARTIALS_FP64_RTOL of scale
PARTIALS_TOL = {"gi_part": 1e-5, "v": 1e-4}
PARTIALS_FP64_RTOL = 1e-5
PARTIALS_BATCHES = (SERVE_BATCH, 37, 1, 1000)
# the ep phase: shards of the in-process split, and the dense steps compared
EP_SHARDS, EP_DENSE_STEPS, EP_PROFILE_STEPS = 4, 10, 2
# MCMC steps of the stepped and replayed EP chain, held to the entry point's
# chain of as many steps on the same draws: 100 (the whole official chain)
# until the deploy phase needed the time; the stepping and its CPU replay
# were the phase's largest share; 25 until the viz phase needed the time, 10
# until the latent_dims phase did
EP_REPLAY_STEPS = 5
# the dense_chain phase: the official chain on the K=20 000 bank, its first
# steps replayed on the CPU (3 until the viz phase needed the time)
DENSE_REPLAY_STEPS = 1
# the analysis metrics of the evaluation step (losses.additional_metrics)
EVAL_METRIC_KEYS = ("cyclicity_error", "latent_norm", "latent_variance",
                    "metric_conditioning", "manifold_regularity", "metric_determinant")

T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")


PHASE_S = {}  # seconds of each main-path phase, printed as it ends and once at the end


def phase(name: str, run, torch, **extra):
    """``run(torch)``, its record printed with the phase's own seconds."""
    t = time.perf_counter()
    out = run(torch)
    PHASE_S[name] = round(time.perf_counter() - t, 3)
    emit(name, **out, phase_s=PHASE_S[name], **extra)
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, n: int = GRAPH_LAUNCHES, replays: int = 3):
    """(device ms per call, outputs): ``fn`` captured ``n`` times in one CUDA
    graph, replayed once, then ``replays`` times between CUDA events, so no
    host issue time is inside; the outputs are the last captured call's after
    the replays.  A launcher that cannot be captured raises."""
    fn()  # warm-up outside the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            out = fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays), out


def cold_device_ms(torch, fn, flush, n: int = GRAPH_LAUNCHES) -> float:
    """Device ms per call of ``fn`` with the L2 cache evicted before each: a
    CUDA graph of (write ``flush``, ``fn``) pairs less one of the writes
    alone, both replayed as in :func:`device_ms`."""
    write = lambda: flush.fill_(1.0)  # noqa: E731

    def pair():
        write()
        return fn()

    return device_ms(torch, pair, n)[0] - device_ms(torch, write, n)[0]


def graph_replay_equal(torch, fn, eager) -> bool:
    """``fn`` captured once in a CUDA graph (after the eager launches that gave
    ``eager``), replayed: the same bits as ``eager``."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, c) for a, c in zip(out, eager))


def with_device_ms(torch, record, fn):
    """``record`` with the device time per launch of ``fn`` (its kernel at the
    record's shape) beside its CUDA-event ``ms``."""
    record["device_ms"], _ = device_ms(torch, fn)
    return record


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------


def metric_banks():
    """(label, centroids, matrices, temperature, lbd): the model's metric, the
    K=200 metric and a K=20 000 synthetic bank."""
    from rlvae_tpu_torch.geometry import load_metric

    banks = []
    for name, t_over in (("metric_T0.7_scaled.npz", 3.0), ("metric.npz", None)):
        m = load_metric(PRETRAINED / name, temperature_override=t_over)
        banks.append((f"{name}(K={m.n_centroids})", m.centroids.numpy(), m.matrices.numpy(),
                      m.temperature, m.regularization))
    rng = np.random.default_rng(0)
    k, d = 20_000, 16
    c = rng.normal(size=(k, d)).astype(np.float32)
    a = (rng.normal(size=(k, d, d)) / np.sqrt(d)).astype(np.float32)
    mats = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)
    banks.append(("synthetic(K=20000)", c, mats, 0.5, 0.01))
    return banks


def chol_cases(torch, dev):
    """(label, z, centroids, matrices, inv_t2, diag) at METRIC_BATCHES rows
    for each bank of :func:`metric_banks`."""
    rng = np.random.default_rng(0)
    for label, c, mats, temp, reg in metric_banks():
        for b in METRIC_BATCHES:
            z = c[rng.integers(0, c.shape[0], size=b)] + 0.05 * rng.normal(size=(b, c.shape[1]))
            yield (f"{label},B={b}", torch.tensor(z, dtype=torch.float32, device=dev),
                   torch.tensor(c, device=dev), torch.tensor(mats, device=dev),
                   1.0 / temp ** 2, reg + 1e-6)


def run_chol_checks(torch, dev):
    """The chol-bundle against its plain version at each bank of
    :func:`metric_banks` and METRIC_BATCHES rows, with the launch geometry of
    each case; at B=64 for each bank device time per launch, bit-identical in
    a graph replay, beside the plain version's time and the bound."""
    from rlvae_tpu_torch.ops.metric_kernels import (
        chol_bundle,
        chol_bundle_ref,
        launch_hmc_geometry,
    )

    cases = []
    for label, z, c, m, inv_t2, diag in chol_cases(torch, dev):
        l_k, ld_k = chol_bundle(z, c, m, inv_t2, diag)
        l_p, ld_p = chol_bundle_ref(z, c, m, inv_t2, diag)
        torch.cuda.synchronize()
        err = max(float((l_k - l_p).abs().max()), float((ld_k - ld_p).abs().max()))
        ok = bool(torch.all((l_k - l_p).abs() <= CHOL_ATOL + CHOL_RTOL * l_p.abs())
                  and torch.all((ld_k - ld_p).abs() <= CHOL_ATOL + CHOL_RTOL * ld_p.abs()))
        b, k = z.shape[0], c.shape[0]
        case = {"shape": label, "max_abs_err": err, "ok": ok,
                "geometry": list(launch_hmc_geometry(b, k, dev, "chol_bundle"))[:3],
                "ms": time_ms(torch, lambda: chol_bundle(z, c, m, inv_t2, diag), 20)}
        check(ok, f"chol_bundle disagrees with its plain version at {label}: {err}")
        if b == SERVE_BATCH:
            case["device_ms"], replayed = device_ms(torch, lambda: chol_bundle(z, c, m, inv_t2, diag))
            case["bit_identical_in_graph_replay"] = bool(
                torch.equal(replayed[0], l_k) and torch.equal(replayed[1], ld_k))
            check(case["bit_identical_in_graph_replay"],
                  f"chol_bundle's graph replay differs from its eager launch at {label}")
            flops = b * (k * (3 * 16 + 1 + 2 * 16 * 16) + 16 ** 3 / 3 + 16)
            case["bound_ms"], case["bound_by"] = bound_ms(nbytes(z, c, m, l_k, ld_k), flops)
            case["plain_ms"] = time_ms(torch, lambda: chol_bundle_ref(z, c, m, inv_t2, diag), 10)
        cases.append(case)
    timed = [c for c in cases if "device_ms" in c]
    main = next(c for c in timed if c["shape"].startswith("metric_T0.7"))
    record = {
        "name": "chol_bundle", "route": "cuda",
        "source": "rlvae_tpu_torch/csrc/chol_bundle.cu",
        "replaces": "rlvae_tpu/ops/metric_kernels.py:470",
        "shape": main["shape"], "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": f"|kernel-plain| <= {CHOL_ATOL} + {CHOL_RTOL}*|plain|; bit-identical in a "
                     f"CUDA-graph replay",
    }
    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "geometry"):
        record[f"{key}_by_shape"] = {c["shape"]: c[key] for c in timed}
    return record, cases


def _scaled_err(got, want):
    """max over transitions of max|got-want| / max|want| (per transition)."""
    scale = want.abs().flatten(1).max(1).values.clamp_min(1e-30)
    return float(((got - want).abs().flatten(1).max(1).values / scale).max())


def chain_weights(torch, dev, bias):
    """The stacked weights of the preset's 7-transition chain, flows at the
    seeded init with log-sigma bias ``bias`` (0.0: near-identity flows;
    the preset's -2.0: the model's reference init)."""
    from rlvae_tpu_torch.flows import TemporalFlows
    from rlvae_tpu_torch.models import PRESETS
    from rlvae_tpu_torch.ops.iaf_kernels import stack_chain

    p = PRESETS["riemannian_flow_vae"]
    g = torch.Generator().manual_seed(0)
    tf = TemporalFlows(p["latent_dim"], p["n_flows"], p["flow_hidden_size"],
                       p["flow_n_blocks"], p["flow_n_hidden"],
                       log_var_bias_init=bias, generator=g).to(dev).requires_grad_(False)
    return stack_chain([tf.flows[min(t, tf.n_flows - 1)] for t in range(N_TRANSITIONS)])


def pass_flops(d=16, h=256, nh=3):
    """FLOP of one MADE pass for one row."""
    return 2 * (d * h + (nh - 1) * h * h + h * 2 * d)


def seq_step_flops(i, h=256, nh=3):
    """FLOP of reverse step i of the sequential backward for one row: the
    recomputed pass, its VJP and the weight-gradient outer products, each
    over what the step needs (layer 0's first i input columns, the hidden
    layers, the output columns i and D + i)."""
    return 3 * 2 * (i * h + (nh - 1) * h * h + 2 * h)


IAF_FWD_BATCHES = (1, 7, TRAIN_BATCH, SERVE_BATCH)


def iaf_instantiations():
    """The two instantiations of each IAF-chain kernel: weights resident in
    shared memory (what the wrappers launch at the preset's shape) and
    streamed from global memory (what they launch where the weights do not
    fit), both driven at the same shape."""
    from rlvae_tpu_torch.ops.iaf_kernels import _launch_bwd, _launch_fwd

    return {
        "resident": (lambda z0, w, ys=False: _launch_fwd(z0, tuple(w), ys),
                     lambda ys, dz, dld, w: _launch_bwd(ys, dz, dld, tuple(w))),
        "streamed": (lambda z0, w, ys=False: _launch_fwd(z0, tuple(w), ys, stream_weights=True),
                     lambda ys, dz, dld, w: _launch_bwd(ys, dz, dld, tuple(w),
                                                        stream_weights=True)),
    }


def run_iaf_checks(torch, dev):
    from rlvae_tpu_torch.ops.iaf_kernels import (
        iaf_chain_fwd,
        iaf_chain_fwd_ref,
        launch_geometry,
    )

    nt = N_TRANSITIONS
    w_near_id = chain_weights(torch, dev, 0.0)
    wm = chain_weights(torch, dev, -2.0)
    wm64 = [w.double() for w in wm]
    rng = np.random.default_rng(1)
    cases, record = [], None
    for b in IAF_FWD_BATCHES:
        z0 = torch.tensor(rng.normal(size=(b, 16)), dtype=torch.float32, device=dev)
        z_p, ld_p, ys_p = iaf_chain_fwd_ref(z0, *w_near_id, return_ys=True)
        z_64, _ = iaf_chain_fwd_ref(z0.double(), *wm64)
        plain_t = []  # per transition: (input, plain fp32 z and ld, fp64 z and ld)
        for t in range(nt):
            x_in = (z0 if t == 0 else z_64[t - 1].float()).contiguous()
            w_t = [x[t : t + 1].contiguous() for x in wm]
            plain_t.append((x_in, w_t, iaf_chain_fwd_ref(x_in, *w_t),
                            iaf_chain_fwd_ref(x_in.double(), *(x[t : t + 1] for x in wm64))))
        case = {"shape": f"B={b},D=16,H=256,NB=2,NH=3,NT={nt}",
                "geometry": launch_geometry(b, 16, 256, 3), "ok": True, "max_abs_err": 0.0}
        for inst, (fwd, _) in iaf_instantiations().items():
            # (a) the whole chain, near-identity flows: errors stay at rounding;
            # the residual ys (each block's output) too
            z_k, ld_k, ys_k = fwd(z0, w_near_id, True)
            check(torch.equal(fwd(z0, w_near_id)[0], z_k), "ys output changed z")
            check(torch.equal(fwd(z0, w_near_id, True)[2], ys_k), "relaunch changed ys")
            rel_a = max(_scaled_err(z_k, z_p), _scaled_err(ld_k, ld_p), _scaled_err(ys_k, ys_p))
            abs_a = max(float((z_k - z_p).abs().max()), float((ld_k - ld_p).abs().max()),
                        float((ys_k - ys_p).abs().max()))
            # (b) the model's reference-init flows, which scale |z| ~20x per
            # transition: rounding is amplified inside each transition, so the
            # kernel is held to an fp64 evaluation, no less accurate than the
            # plain fp32 version; each transition starts from the fp64 chain's
            # input to it
            rel_b = rel_p = abs_b = abs_kp = 0.0
            for x_in, w_t, (zp, ldp), (ze, lde) in plain_t:
                zt, ldt = fwd(x_in, w_t)
                rel_b = max(rel_b, _scaled_err(zt.double(), ze), _scaled_err(ldt.double(), lde))
                rel_p = max(rel_p, _scaled_err(zp.double(), ze), _scaled_err(ldp.double(), lde))
                abs_b = max(abs_b, float((zt.double() - ze).abs().max()))
                abs_kp = max(abs_kp, float((zt - zp).abs().max()), float((ldt - ldp).abs().max()))
            torch.cuda.synchronize()
            ok = rel_a <= IAF_RTOL and rel_b <= max(IAF_FP64_FACTOR * rel_p, IAF_RTOL)
            case[inst] = {
                "chain_near_identity": {"max_rel_err": rel_a, "max_abs_err": abs_a},
                "per_transition_model_init_vs_fp64": {
                    "kernel_max_rel_err": rel_b, "plain_fp32_max_rel_err": rel_p,
                    "kernel_max_abs_err": abs_b, "kernel_vs_plain_max_abs_err": abs_kp},
                "ms": time_ms(torch, lambda: fwd(z0, wm), 10), "ok": ok}
            case["ok"] &= ok
            case["max_abs_err"] = max(case["max_abs_err"], abs_a, abs_kp)
            check(ok, f"iaf_chain_fwd ({inst}) disagrees at B={b}: {rel_a}, {rel_b} "
                      f"(plain fp32 {rel_p})")
        case["ms"] = time_ms(torch, lambda: iaf_chain_fwd(z0, *wm), 10)
        cases.append(case)
        if b == SERVE_BATCH:
            d, nb = 16, 2
            flops = b * nt * nb * d * pass_flops()
            z_k, ld_k = iaf_chain_fwd(z0, *wm)
            bms, by = bound_ms(nbytes(z0, *wm, z_k, ld_k), flops)
            record = with_device_ms(torch, {
                "name": "iaf_chain_fwd", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/iaf_chain.cu",
                "replaces": "rlvae_tpu/ops/iaf_kernels.py:546",
                "shape": case["shape"], "ms": case["ms"],
                "plain_ms": time_ms(torch, lambda: iaf_chain_fwd_ref(z0, *wm), 2, warmup=1),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
            }, lambda: iaf_chain_fwd(z0, *wm))
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    record["ms_by_batch"] = {c["shape"].split(",")[0]: c["ms"] for c in cases}
    record["ms_streamed_by_batch"] = {c["shape"].split(",")[0]: c["streamed"]["ms"]
                                      for c in cases}
    record["tolerance"] = (f"near-identity chain: |kernel-plain| <= {IAF_RTOL}*max|plain| per "
                           f"transition (z, ld and the residual ys); reference init: error vs "
                           f"fp64 <= max({IAF_FP64_FACTOR}x the plain fp32 version's, {IAF_RTOL}) "
                           f"per transition; both instantiations (weights resident, streamed); "
                           f"bit-identical on relaunch")
    return record, cases


def _bwd_err(got, want):
    """Largest error of (dz0, weight grads) relative to scale: dz0 against
    its largest entry, each weight gradient per transition."""
    dz0_g, grads_g = got
    dz0_w, grads_w = want
    errs = [_scaled_err(dz0_g.double()[None], dz0_w.double()[None])]
    errs += [_scaled_err(a.double(), b.double()) for a, b in zip(grads_g, grads_w)]
    return max(errs)


def _bwd_abs(got, want):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip((got[0], *got[1]), (want[0], *want[1])))


def run_iaf_bwd_checks(torch, dev):
    """The IAF-chain backward against its plain version, in both
    instantiations: (a) the whole chain at the near-identity init, both from
    the same residual ys, bit-identical on relaunch; (b) at the reference
    init, each transition alone from the fp64 chain's residual, kernel and
    plain fp32 version both against fp64.  Each batch also times the
    caller's sum of the weight-gradient workspace (one slot per cluster)."""
    from rlvae_tpu_torch.ops.iaf_kernels import (
        bwd_workspace,
        iaf_chain_bwd,
        iaf_chain_bwd_ref,
        iaf_chain_fwd,
        iaf_chain_fwd_ref,
        launch_geometry,
    )

    nt, d = N_TRANSITIONS, 16
    w_near_id = chain_weights(torch, dev, 0.0)
    wm = chain_weights(torch, dev, -2.0)
    wm64 = [w.double() for w in wm]
    rng = np.random.default_rng(3)
    cases, record = [], None
    for b in BWD_BATCHES:
        z0 = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32, device=dev)
        dz = torch.tensor(rng.normal(size=(nt, b, d)), dtype=torch.float32, device=dev)
        dld = torch.tensor(rng.normal(size=(nt, b)), dtype=torch.float32, device=dev)
        _, _, ys = iaf_chain_fwd_ref(z0, *w_near_id, return_ys=True)
        want = iaf_chain_bwd_ref(ys, dz, dld, *w_near_id)
        _, _, ys64 = iaf_chain_fwd_ref(z0.double(), *wm64, return_ys=True)
        plain_t = []
        for t in range(nt):
            w_t = [x[t : t + 1].contiguous() for x in wm]
            args = (ys64[t : t + 1].float().contiguous(), dz[t : t + 1].contiguous(),
                    dld[t : t + 1].contiguous())
            plain_t.append((args, w_t, iaf_chain_bwd_ref(*args, *w_t),
                            iaf_chain_bwd_ref(*(a.double() for a in args),
                                              *(x[t : t + 1] for x in wm64))))
        _, _, ys_m = iaf_chain_fwd(z0, *wm, return_ys=True)
        case = {"shape": f"B={b},D=16,H=256,NB=2,NH=3,NT={nt}",
                "geometry": launch_geometry(b, 16, 256, 3, backward=True), "ok": True}
        for inst, (_, bwd) in iaf_instantiations().items():
            got = bwd(ys, dz, dld, w_near_id)
            again = bwd(ys, dz, dld, w_near_id)
            check(torch.equal(got[0], again[0]) and all(map(torch.equal, got[1], again[1])),
                  f"iaf_chain_bwd ({inst}) changed on relaunch at B={b}")
            rel_a, abs_a = _bwd_err(got, want), _bwd_abs(got, want)
            rel_b = rel_p = abs_kp = 0.0
            for args, w_t, p, e in plain_t:
                k = bwd(*args, w_t)
                rel_b, rel_p = max(rel_b, _bwd_err(k, e)), max(rel_p, _bwd_err(p, e))
                abs_kp = max(abs_kp, _bwd_abs(k, p))
            torch.cuda.synchronize()
            ok = rel_a <= IAF_RTOL and rel_b <= max(IAF_FP64_FACTOR * rel_p, IAF_RTOL)
            case[inst] = {
                "chain_near_identity": {"max_rel_err": rel_a, "max_abs_err": abs_a},
                "per_transition_model_init_vs_fp64": {
                    "kernel_max_rel_err": rel_b, "plain_fp32_max_rel_err": rel_p,
                    "kernel_vs_plain_max_abs_err": abs_kp},
                "ms": time_ms(torch, lambda: bwd(ys_m, dz, dld, wm), 5), "ok": ok}
            case["ok"] &= ok
            case["max_abs_err"] = max(case.get("max_abs_err", 0.0), abs_a)
            check(ok, f"iaf_chain_bwd ({inst}) disagrees at B={b}: {rel_a}, {rel_b} "
                      f"(plain fp32 {rel_p})")
        case["ms"] = time_ms(torch, lambda: iaf_chain_bwd(ys_m, dz, dld, *wm), 5)
        parts = [p.zero_() for p in bwd_workspace(b, tuple(wm))]
        case["workspace"] = {"clusters": parts[0].shape[0],
                             "bytes": sum(p.numel() * p.element_size() for p in parts),
                             "sum_ms": time_ms(torch, lambda: [p.sum(0) for p in parts], 10)}
        cases.append(case)
        if b == SERVE_BATCH:
            nb = 2
            # per block and transition: the pass, D sweeps, the final VJP and
            # its weight-gradient outer products, each about one MADE pass
            flops = b * nt * nb * (d + 3) * pass_flops()
            out = iaf_chain_bwd(ys_m, dz, dld, *wm)
            bms, by = bound_ms(nbytes(ys_m, dz, dld, *wm, out[0], *out[1]), flops)
            record = with_device_ms(torch, {
                "name": "iaf_chain_bwd", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/iaf_chain_bwd.cu",
                "replaces": "rlvae_tpu/ops/iaf_kernels.py:585",
                "shape": case["shape"], "ms": case["ms"],
                "plain_ms": time_ms(torch, lambda: iaf_chain_bwd_ref(ys_m, dz, dld, *wm), 2,
                                    warmup=1),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
            }, lambda: iaf_chain_bwd(ys_m, dz, dld, *wm))
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    record["ms_by_batch"] = {c["shape"].split(",")[0]: c["ms"] for c in cases}
    record["ms_streamed_by_batch"] = {c["shape"].split(",")[0]: c["streamed"]["ms"]
                                      for c in cases}
    record["tolerance"] = (f"near-identity chain: |kernel-plain| <= {IAF_RTOL}*scale (dz0 by its "
                           f"largest entry, weight grads per transition); reference init: error "
                           f"vs fp64 <= max({IAF_FP64_FACTOR}x the plain fp32 version's, "
                           f"{IAF_RTOL}) per transition; both instantiations (weights resident, "
                           f"streamed); bit-identical on relaunch")
    return record, cases


# The Jacobi fixed-point mode of the IAF-chain kernels (fp_iters = K): the
# forward at K and its backward at K + 1 sweeps, at K = 2, the fixedpoint
# phase's 8, and D - 1 = 15 (exact: also held to the sequential kernel)
JACOBI_ITERS = (2, 8, 15)
JACOBI_BATCHES = (TRAIN_BATCH, SERVE_BATCH)


def layer_steps(k: int = 0, backward: bool = False, nt: int = N_TRANSITIONS, nb: int = 2,
                d: int = 16, nh: int = 3, sequential: bool = False) -> int:
    """Dependent layer steps of one chain launch: per block, each MADE pass
    (NH+1 layers; the forward's D passes or K+1 Jacobi passes; the
    backward's recomputed pass, its sweeps, D or K+1, and the final VJP;
    the sequential backward's D reverse steps, each a pass and its VJP),
    plus the flip."""
    if sequential:
        return nt * nb * (d * 2 * (nh + 1) + 1)
    passes = ((d if k == 0 else k + 1) + 2) if backward else (d if k == 0 else k + 1)
    return nt * nb * (passes * (nh + 1) + 1)


def run_iaf_jacobi_checks(torch, dev):
    """The IAF-chain kernels in the Jacobi mode, both instantiations, at the
    near-identity init: the forward (z, ld and the residual ys) against its
    plain version and an fp64 evaluation; the backward at K+1 sweeps from the
    plain residual against its plain version and fp64; each bit-identical on
    relaunch and in a CUDA-graph replay; K = D - 1 against the sequential
    kernel (within fp32 rounding, not bitwise: layer 0 is a full product
    there, D incremental FMAs in the sequential mode).  Times at B=64 (graph
    replay and CUDA events) with the bound and the dependent layer steps."""
    from rlvae_tpu_torch.ops.iaf_kernels import (
        _launch_bwd,
        _launch_fwd,
        iaf_chain_bwd,
        iaf_chain_bwd_ref,
        iaf_chain_fwd,
        iaf_chain_fwd_ref,
        launch_geometry,
    )

    nt, d, nb = N_TRANSITIONS, 16, 2
    w = chain_weights(torch, dev, 0.0)
    w64 = [x.double() for x in w]
    rng = np.random.default_rng(7)
    cases, timing = [], {"fwd": {}, "bwd": {}}
    for b in JACOBI_BATCHES:
        z0 = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32, device=dev)
        dz = torch.tensor(rng.normal(size=(nt, b, d)), dtype=torch.float32, device=dev)
        dld = torch.tensor(rng.normal(size=(nt, b)), dtype=torch.float32, device=dev)
        for k in JACOBI_ITERS:
            s = k + 1
            z_p, ld_p, ys_p = iaf_chain_fwd_ref(z0, *w, return_ys=True, fp_iters=k)
            z_e, ld_e, ys_e = iaf_chain_fwd_ref(z0.double(), *w64, return_ys=True, fp_iters=k)
            g_p = iaf_chain_bwd_ref(ys_p, dz, dld, *w, n_sweeps=s)
            g_e = iaf_chain_bwd_ref(ys_e, dz.double(), dld.double(), *w64, n_sweeps=s)
            fwd_pe = max(_scaled_err(z_p.double(), z_e), _scaled_err(ld_p.double(), ld_e))
            bwd_pe = _bwd_err(g_p, g_e)
            case = {"shape": f"B={b},K={k},sweeps={s},D=16,H=256,NB=2,NH=3,NT={nt}",
                    "geometry": launch_geometry(b, d, 256, 3, fp_iters=k), "ok": True,
                    "max_abs_err": 0.0}
            for inst, streamed in (("resident", False), ("streamed", True)):
                fwd = lambda: _launch_fwd(z0, w, True, stream_weights=streamed, fp_iters=k)  # noqa: E731
                bwd = lambda: _launch_bwd(ys_p, dz, dld, w, stream_weights=streamed,  # noqa: E731
                                          n_sweeps=s)
                out_f, out_b = fwd(), bwd()
                again_f, again_b = fwd(), bwd()
                check(all(map(torch.equal, out_f, again_f)) and torch.equal(out_b[0], again_b[0])
                      and all(map(torch.equal, out_b[1], again_b[1])),
                      f"the Jacobi kernels ({inst}) changed on relaunch at B={b}, K={k}")
                z_k, ld_k, ys_k = out_f
                rel_f = max(_scaled_err(z_k, z_p), _scaled_err(ld_k, ld_p),
                            _scaled_err(ys_k, ys_p))
                rel_fe = max(_scaled_err(z_k.double(), z_e), _scaled_err(ld_k.double(), ld_e))
                rel_b, rel_be = _bwd_err(out_b, g_p), _bwd_err(out_b, g_e)
                ok = (rel_f <= IAF_RTOL and rel_fe <= max(IAF_FP64_FACTOR * fwd_pe, IAF_RTOL)
                      and rel_b <= IAF_RTOL and rel_be <= max(IAF_FP64_FACTOR * bwd_pe, IAF_RTOL))
                case[inst] = {
                    "fwd": {"vs_plain_max_rel_err": rel_f, "vs_fp64_max_rel_err": rel_fe,
                            "plain_fp32_vs_fp64_max_rel_err": fwd_pe},
                    "bwd": {"vs_plain_max_rel_err": rel_b, "vs_fp64_max_rel_err": rel_be,
                            "plain_fp32_vs_fp64_max_rel_err": bwd_pe}, "ok": ok}
                case["ok"] &= ok
                case["max_abs_err"] = max(case["max_abs_err"],
                                          float((z_k - z_p).abs().max()),
                                          float((ld_k - ld_p).abs().max()), _bwd_abs(out_b, g_p))
                check(ok, f"the Jacobi kernels ({inst}) disagree at B={b}, K={k}: fwd "
                          f"{rel_f}, {rel_fe} (plain {fwd_pe}); bwd {rel_b}, {rel_be} "
                          f"(plain {bwd_pe})")
            eager_f = iaf_chain_fwd(z0, *w, return_ys=True, fp_iters=k)
            eager_b = iaf_chain_bwd(ys_p, dz, dld, *w, n_sweeps=s)
            case["bit_identical_in_graph_replay"] = (
                graph_replay_equal(torch, lambda: iaf_chain_fwd(z0, *w, return_ys=True,
                                                                fp_iters=k), eager_f)
                and graph_replay_equal(torch, lambda: (lambda g: (g[0], *g[1]))(
                    iaf_chain_bwd(ys_p, dz, dld, *w, n_sweeps=s)), (eager_b[0], *eager_b[1])))
            check(case["bit_identical_in_graph_replay"],
                  f"the Jacobi kernels changed in a CUDA-graph replay at B={b}, K={k}")
            if k == d - 1:
                z_s, ld_s = iaf_chain_fwd(z0, *w)
                case["vs_sequential_kernel"] = {
                    "max_rel_err": max(_scaled_err(eager_f[0], z_s), _scaled_err(eager_f[1], ld_s)),
                    "bitwise": bool(torch.equal(eager_f[0], z_s) and torch.equal(eager_f[1], ld_s))}
                check(case["vs_sequential_kernel"]["max_rel_err"] <= IAF_RTOL,
                      f"the exact Jacobi mode disagrees with the sequential kernel at B={b}")
            if b == SERVE_BATCH:
                zf, ldf = iaf_chain_fwd(z0, *w, fp_iters=k)
                bms, by = bound_ms(nbytes(z0, *w, zf, ldf), b * nt * nb * s * pass_flops())
                timing["fwd"][f"K={k}"] = with_device_ms(torch, {
                    "ms": time_ms(torch, lambda: iaf_chain_fwd(z0, *w, fp_iters=k), 10),
                    "plain_ms": time_ms(torch, lambda: iaf_chain_fwd_ref(z0, *w, fp_iters=k), 2,
                                        warmup=1),
                    "bound_ms": bms, "bound_by": by, "dependent_layer_steps": layer_steps(k)},
                    lambda: iaf_chain_fwd(z0, *w, fp_iters=k))
                # per block: the recomputed pass, s sweeps, the final VJP and
                # its outer products, each about one MADE pass
                bms, by = bound_ms(nbytes(ys_p, dz, dld, *w, eager_b[0], *eager_b[1]),
                                   b * nt * nb * (s + 3) * pass_flops())
                timing["bwd"][f"sweeps={s}"] = with_device_ms(torch, {
                    "ms": time_ms(torch, lambda: iaf_chain_bwd(ys_p, dz, dld, *w, n_sweeps=s), 5),
                    "plain_ms": time_ms(torch, lambda: iaf_chain_bwd_ref(ys_p, dz, dld, *w,
                                                                         n_sweeps=s), 2, warmup=1),
                    "bound_ms": bms, "bound_by": by,
                    "dependent_layer_steps": layer_steps(k, backward=True)},
                    lambda: iaf_chain_bwd(ys_p, dz, dld, *w, n_sweeps=s))
            cases.append(case)
    # the sequential mode beside them, same inputs and call: the comparison's base
    z0 = torch.tensor(rng.normal(size=(SERVE_BATCH, d)), dtype=torch.float32, device=dev)
    timing["fwd"]["sequential"] = {"device_ms": device_ms(torch, lambda: iaf_chain_fwd(z0, *w))[0],
                                   "dependent_layer_steps": layer_steps()}
    _, _, ys = iaf_chain_fwd(z0, *w, return_ys=True)
    dz = torch.tensor(rng.normal(size=(nt, SERVE_BATCH, d)), dtype=torch.float32, device=dev)
    dld = torch.tensor(rng.normal(size=(nt, SERVE_BATCH)), dtype=torch.float32, device=dev)
    timing["bwd"]["sequential"] = {
        "device_ms": device_ms(torch, lambda: iaf_chain_bwd(ys, dz, dld, *w))[0],
        "dependent_layer_steps": layer_steps(backward=True)}
    tolerance = (f"near-identity chain: |kernel-plain| <= {IAF_RTOL}*scale (z, ld, ys per "
                 f"transition; dz0 and weight grads per tensor); vs fp64 <= max("
                 f"{IAF_FP64_FACTOR}x the plain fp32 version's, {IAF_RTOL}); both "
                 f"instantiations; bit-identical on relaunch and in a CUDA-graph replay; "
                 f"K=15 vs the sequential kernel <= {IAF_RTOL}*scale (not bitwise)")
    return {"cases": cases, "timing_b64": timing, "tolerance": tolerance}


# The sequential mode of the IAF-chain backward (n_sweeps = 0, JAX's
# adj_sweeps = 0, reached through ADJ_SWEEPS_OVERRIDE): the train step's
# B=16, the serving bucket's 64, one row, and 37, not a multiple of R = 8
SEQ_BWD_BATCHES = (1, TRAIN_BATCH, 37, SERVE_BATCH)


def run_iaf_seq_bwd_checks(torch, dev):
    """The backward's sequential mode in both instantiations: (a) at the
    near-identity init against its plain version; (b) at the reference init
    against fp64, no less accurate than the plain fp32 version (the
    adjoint's tolerances); bit-identical on relaunch; at B=64 against the
    adjoint mode after the MADE masks (the raw entries the masks zero
    differ), bit-identical in a CUDA-graph replay, and timed (a replayed
    graph and CUDA events) beside its plain version, the adjoint mode in
    the same call, its bound and its dependent layer steps."""
    from rlvae_tpu_torch.ops.iaf_kernels import (
        _launch_bwd,
        iaf_chain_bwd,
        iaf_chain_bwd_ref,
        iaf_chain_fwd_ref,
        launch_geometry,
    )

    nt, d, nb = N_TRANSITIONS, 16, 2
    weights = {"near_identity": chain_weights(torch, dev, 0.0),
               "model_init": chain_weights(torch, dev, -2.0)}
    rng = np.random.default_rng(12)
    cases, timing = [], None
    for b in SEQ_BWD_BATCHES:
        z0 = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32, device=dev)
        dz = torch.tensor(rng.normal(size=(nt, b, d)), dtype=torch.float32, device=dev)
        dld = torch.tensor(rng.normal(size=(nt, b)), dtype=torch.float32, device=dev)
        case = {"shape": f"B={b},D=16,H=256,NB=2,NH=3,NT={nt}",
                "geometry": launch_geometry(b, d, 256, 3, backward=True), "ok": True,
                "max_abs_err": 0.0}
        for init, w in weights.items():
            _, _, ys = iaf_chain_fwd_ref(z0, *w, return_ys=True)
            want = iaf_chain_bwd_ref(ys, dz, dld, *w, n_sweeps=0, z0=z0)
            want64 = iaf_chain_bwd_ref(ys.double(), dz.double(), dld.double(),
                                       *(x.double() for x in w), n_sweeps=0, z0=z0.double())
            plain64 = _bwd_err(want, want64)
            for inst, streamed in (("resident", False), ("streamed", True)):
                got = _launch_bwd(ys, dz, dld, w, stream_weights=streamed, n_sweeps=0, z0=z0)
                again = _launch_bwd(ys, dz, dld, w, stream_weights=streamed, n_sweeps=0, z0=z0)
                torch.cuda.synchronize()
                check(torch.equal(got[0], again[0]) and all(map(torch.equal, got[1], again[1])),
                      f"the sequential backward ({inst}) changed on relaunch at B={b}")
                rel, rel64 = _bwd_err(got, want), _bwd_err(got, want64)
                ok = (rel <= IAF_RTOL if init == "near_identity"
                      else rel64 <= max(IAF_FP64_FACTOR * plain64, IAF_RTOL))
                case[f"{init}_{inst}"] = {"vs_plain_max_rel_err": rel,
                                          "vs_fp64_max_rel_err": rel64,
                                          "plain_fp32_vs_fp64_max_rel_err": plain64, "ok": ok}
                case["ok"] &= ok
                case["max_abs_err"] = max(case["max_abs_err"], _bwd_abs(got, want))
                check(ok, f"the sequential backward ({inst}, {init}) disagrees at B={b}: "
                          f"{rel}, vs fp64 {rel64} (plain fp32 {plain64})")
        cases.append(case)
        if b != SERVE_BATCH:
            continue
        w = weights["near_identity"]
        _, _, ys = iaf_chain_fwd_ref(z0, *w, return_ys=True)
        seq = lambda: iaf_chain_bwd(ys, dz, dld, *w, n_sweeps=0, z0=z0)  # noqa: E731
        eager = seq()
        case["bit_identical_in_graph_replay"] = graph_replay_equal(
            torch, lambda: (lambda g: (g[0], *g[1]))(seq()), (eager[0], *eager[1]))
        check(case["bit_identical_in_graph_replay"],
              "the sequential backward changed in a CUDA-graph replay at B=64")
        adj = iaf_chain_bwd(ys, dz, dld, *w)
        masks = [(x != 0).to(torch.float32) for x in w]
        case["vs_adjoint_after_masks_max_rel_err"] = _bwd_err(
            (eager[0], [g * m for g, m in zip(eager[1], masks)]),
            (adj[0], [g * m for g, m in zip(adj[1], masks)]))
        check(case["vs_adjoint_after_masks_max_rel_err"] <= IAF_RTOL,
              f"the sequential backward vs the adjoint mode at B=64: "
              f"{case['vs_adjoint_after_masks_max_rel_err']}")
        # per block, D reverse steps
        bms, by = bound_ms(nbytes(ys, dz, dld, z0, *w, eager[0], *eager[1]),
                           b * nt * nb * sum(seq_step_flops(i) for i in range(d)))
        timing = with_device_ms(torch, {
            "ms": time_ms(torch, seq, 5),
            "plain_ms": time_ms(torch, lambda: iaf_chain_bwd_ref(ys, dz, dld, *w, n_sweeps=0,
                                                                 z0=z0), 1, warmup=1),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "dependent_layer_steps": layer_steps(sequential=True),
            "adjoint_device_ms_same_call": device_ms(
                torch, lambda: iaf_chain_bwd(ys, dz, dld, *w))[0]}, seq)
    tolerance = (f"near-identity chain: |kernel-plain| <= {IAF_RTOL}*scale (dz0 by its "
                 f"largest entry, weight grads per transition); reference init: error vs fp64 "
                 f"<= max({IAF_FP64_FACTOR}x the plain fp32 version's, {IAF_RTOL}); both "
                 f"instantiations; bit-identical on relaunch and in a CUDA-graph replay; at "
                 f"B=64 vs the adjoint mode <= {IAF_RTOL}*scale after the MADE masks")
    return {"cases": cases, "timing_b64": timing, "tolerance": tolerance}


def hmc_flops(b: int, k: int, d: int = 16) -> float:
    """FLOP of the HMC terms: per row and centroid, d^2 (3d) and its exp,
    the weighted sum of M (2d^2), the weighted differences (2d) and their
    contraction with M (2d^2); per row, the Cholesky (d^3/3), two
    triangular solves (2d^2) and the logs."""
    return b * (k * (3 * d + 1 + 2 * d * d + 2 * d + 2 * d * d) + d ** 3 / 3 + 2 * d * d + d)


def hmc_cases(torch, dev, batches=HMC_BATCHES):
    """(label, z, centroids, matrices, inv_t2, lbd) for the model's metric,
    the K=200 metric and a K=20 000 bank, at each of ``batches``; the last two
    rows of each batch with B > 1 lie far from every centroid."""
    rng = np.random.default_rng(5)
    for label, c, mats, temp, reg in metric_banks():
        ct, mt = torch.tensor(c, device=dev), torch.tensor(mats, device=dev)
        for b in batches:
            z = c[rng.integers(0, c.shape[0], size=b)] + 0.05 * rng.normal(size=(b, c.shape[1]))
            if b > 1:
                z[-2:] += 100.0
            yield (f"{label},B={b}", torch.tensor(z, dtype=torch.float32, device=dev), ct, mt,
                   1.0 / temp ** 2, reg)


def padded_bank(dev):
    """(label, the seeded K=37 metric, the same padded to 40 as the sharded
    path pads it: far centroids, zero matrices), both on ``dev``."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.parallel import pad_metric

    rng = np.random.default_rng(37)
    a = (rng.normal(size=(37, 16, 16)) / 4).astype(np.float32)
    small = CentroidMetric.create(rng.normal(size=(37, 16)),
                                  a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(16), 0.8)
    padded = pad_metric(small, EP_SHARDS)
    on_dev = lambda mt: CentroidMetric(mt.centroids.to(dev), mt.matrices.to(dev),  # noqa: E731
                                       mt.temperature, mt.regularization)
    return "synthetic(K=37 padded to 40)", on_dev(small), on_dev(padded)


def run_hmc_checks(torch, dev):
    """The HMC terms against their plain fp32 version and an fp64 evaluation
    at each bank of :func:`metric_banks` and the padded K=37 bank, B = 1, 37,
    64, 1000, 50 and 4096 (every geometry the rule picks there, and the
    adaptive sampler's calibration and pool); bit-identical on
    relaunch and in a CUDA-graph replay, the padded bank bit-identical to the
    unpadded one, far rows on the plateau with a zero gradient; each case
    timed with CUDA events and as device time per launch."""
    from rlvae_tpu_torch.ops.metric_kernels import hmc_terms, hmc_terms_ref, launch_hmc_geometry

    log_eps = float(np.log(np.float32(1e-10)))
    label37, small, padded = padded_bank(dev)
    rng = np.random.default_rng(6)
    padded_cases = []
    for b in HMC_KERNEL_BATCHES:
        zn = small.centroids.cpu().numpy()[rng.integers(0, 37, size=b)]
        zn = zn + 0.05 * rng.normal(size=zn.shape)
        if b > 1:
            zn[-2:] += 100.0
        padded_cases.append((f"{label37},B={b}", torch.tensor(zn, dtype=torch.float32, device=dev),
                             padded.centroids, padded.matrices, 1.0 / padded.temperature ** 2,
                             padded.regularization))
    cases, record = [], None
    for label, z, c, m, inv_t2, lbd in [*hmc_cases(torch, dev, HMC_KERNEL_BATCHES),
                                        *padded_cases]:
        args = (inv_t2, lbd, log_eps)
        lp_k, g_k = hmc_terms(z, c, m, *args)
        again = hmc_terms(z, c, m, *args)
        lp_p, g_p = hmc_terms_ref(z, c, m, *args)
        lp_e, g_e = hmc_terms_ref(z.double(), c.double(), m.double(), *args)
        torch.cuda.synchronize()
        g_scale = float(g_e.abs().max().clamp_min(1e-30))
        err = {"kernel_vs_plain": {"log_pi_abs": float((lp_k - lp_p).abs().max()),
                                   "grad_rel": float((g_k - g_p).abs().max()) / g_scale},
               "kernel_vs_fp64": {"log_pi_abs": float((lp_k.double() - lp_e).abs().max()),
                                  "grad_rel": float((g_k.double() - g_e).abs().max()) / g_scale},
               "plain_vs_fp64": {"log_pi_abs": float((lp_p.double() - lp_e).abs().max()),
                                 "grad_rel": float((g_p.double() - g_e).abs().max()) / g_scale}}
        kp, ke, pe = err["kernel_vs_plain"], err["kernel_vs_fp64"], err["plain_vs_fp64"]
        lp_scale = float(lp_e.abs().max())
        ok = (kp["log_pi_abs"] <= HMC_LP_ATOL and kp["grad_rel"] <= HMC_RTOL
              and ke["log_pi_abs"] <= max(IAF_FP64_FACTOR * pe["log_pi_abs"], HMC_RTOL * lp_scale)
              and ke["grad_rel"] <= max(IAF_FP64_FACTOR * pe["grad_rel"], HMC_RTOL))
        same = bool(torch.equal(lp_k, again[0]) and torch.equal(g_k, again[1]))
        if z.shape[0] > 1:  # the far rows: the log 1e-10 plateau and a zero gradient
            ok = ok and bool(torch.all(g_k[-2:] == 0)) and bool(
                torch.all((lp_k[-2:] - log_eps).abs() <= HMC_LP_ATOL))
        if label.startswith(label37):  # the padded centroids add exact zeros
            unpadded = hmc_terms(z, small.centroids, small.matrices, *args)
            same = same and bool(torch.equal(unpadded[0], lp_k) and torch.equal(unpadded[1], g_k))
        b, k = z.shape[0], c.shape[0]
        dms, replayed = device_ms(torch, lambda: hmc_terms(z, c, m, *args))
        graph_same = bool(torch.equal(replayed[0], lp_k) and torch.equal(replayed[1], g_k))
        case = {"shape": label, "ok": ok, **err, "geometry": list(launch_hmc_geometry(b, k, dev)),
                "bit_identical_on_relaunch": same, "bit_identical_in_graph_replay": graph_same,
                "max_abs_err": max(float((lp_k - lp_p).abs().max()),
                                   float((g_k - g_p).abs().max())),
                "ms": time_ms(torch, lambda: hmc_terms(z, c, m, *args), 20), "device_ms": dms}
        case["bound_ms"], case["bound_by"] = bound_ms(nbytes(z, c, m, lp_k, g_k), hmc_flops(b, k))
        cases.append(case)
        check(ok and same and graph_same, f"hmc_terms disagrees at {label}: {case}")
        if label.startswith("metric_T0.7") and label.endswith(f"B={SERVE_BATCH}"):
            record = {
                "name": "hmc_terms", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/hmc_terms.cu",
                "replaces": "rlvae_tpu/ops/metric_kernels.py:809",
                "shape": label, "ms": case["ms"], "device_ms": dms,
                "plain_ms": time_ms(torch, lambda: hmc_terms_ref(z, c, m, *args), 10),
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": None,
            }
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    for key in ("ms", "device_ms", "bound_ms"):
        record[f"{key}_by_shape"] = {c["shape"]: c[key] for c in cases}
    record["tolerance"] = (f"kernel vs plain: |log pi| <= {HMC_LP_ATOL}, |grad| <= {HMC_RTOL} of "
                           f"scale; vs fp64: at most {IAF_FP64_FACTOR}x the plain fp32 version's "
                           f"error, or {HMC_RTOL} of scale; far rows on the plateau, grad 0; "
                           f"bit-identical on relaunch and in a CUDA-graph replay; the padded "
                           f"bank bit-identical to the unpadded one")
    return record, cases


def bundle_flops(b: int, k: int, full: bool, d: int = 16) -> float:
    """FLOP of G^{-1} (per row and centroid: d^2 (3d), its exp, the weighted
    sum of M (2d^2); the diagonal) and, for the full bundle, per row the
    Cholesky (d^3/3), X = L^{-1} (d^3/3), G = X^T X (2d^3/3) and the logs."""
    per_row = k * (3 * d + 1 + 2 * d * d) + d
    if full:
        per_row += 4 * d ** 3 / 3 + d
    return b * per_row


def run_bundle_checks(torch, dev):
    """The metric bundle and G^{-1} against their plain fp32 versions and an
    fp64 evaluation, at each bank of :func:`metric_banks` and METRIC_BATCHES
    rows (:func:`hmc_cases`' rows: near the centroids, the last two of a
    batch far from all of them), with the launch geometry of each case.  Each
    kernel is timed at B=64 for each K, bit-identical in a graph replay."""
    from rlvae_tpu_torch.ops.metric_kernels import (
        g_inv,
        g_inv_ref,
        launch_hmc_geometry,
        metric_bundle,
        metric_bundle_ref,
    )

    names = ("g_inv", "l", "logdet", "g")
    cases = {"metric_bundle": [], "g_inv": []}
    for label, z, c, m, inv_t2, lbd in hmc_cases(torch, dev, METRIC_BATCHES):
        args = (c, m, inv_t2, lbd)
        got = metric_bundle(z, *args)
        gi_k = g_inv(z, *args)
        plain = metric_bundle_ref(z, *args)
        gi_p = g_inv_ref(z, *args)
        want = metric_bundle_ref(z.double(), c.double(), m.double(), inv_t2, lbd)
        torch.cuda.synchronize()
        err, ok = {}, True
        for name, k_out, p_out, e_out in zip(names, got, plain, want):
            rtol, atol = BUNDLE_TOL[name]
            kp = float((k_out - p_out).abs().max())
            ke = float((k_out.double() - e_out).abs().max())
            pe = float((p_out.double() - e_out).abs().max())
            scale = float(e_out.abs().max())
            ok = ok and bool(torch.all((k_out - p_out).abs() <= atol + rtol * p_out.abs()))
            ok = ok and ke <= max(BUNDLE_FP64_FACTOR * pe, BUNDLE_FP64_RTOL * scale)
            err[name] = {"kernel_vs_plain_abs": kp, "kernel_vs_fp64_abs": ke,
                         "plain_vs_fp64_abs": pe, "fp64_scale": scale}
        ok = (ok and bool(torch.all(torch.triu(got[1], 1) == 0))
              and bool(torch.equal(got[3], got[3].transpose(-1, -2)))
              and bool(torch.equal(gi_k, got[0])))
        gi_err = float((gi_k - gi_p).abs().max())
        ok_gi = bool(torch.all((gi_k - gi_p).abs() <= 1e-6 + 1e-5 * gi_p.abs()))
        check(ok, f"metric_bundle disagrees at {label}: {err}")
        check(ok_gi, f"g_inv disagrees with its plain version at {label}: {gi_err}")
        b, k = z.shape[0], c.shape[0]
        bundle = {"shape": label, "ok": ok, "errors": err,
                  "max_abs_err": max(e["kernel_vs_plain_abs"] for e in err.values())}
        gi_case = {"shape": label, "ok": ok_gi, "max_abs_err": gi_err,
                   "kernel_vs_fp64_abs": float((gi_k.double() - want[0]).abs().max()),
                   "identical_to_bundle_g_inv": True}
        geometry = list(launch_hmc_geometry(b, k, dev, "metric_bundle"))[:3]
        bundle["geometry"] = gi_case["geometry"] = geometry
        if b == SERVE_BATCH:
            bundle["ms"] = time_ms(torch, lambda: metric_bundle(z, *args), 20)
            bundle["plain_ms"] = time_ms(torch, lambda: metric_bundle_ref(z, *args), 5)
            bundle["bound_ms"], bundle["bound_by"] = bound_ms(
                nbytes(z, c, m, *got), bundle_flops(b, k, True))
            gi_case["ms"] = time_ms(torch, lambda: g_inv(z, *args), 20)
            bundle["device_ms"], replayed = device_ms(torch, lambda: metric_bundle(z, *args))
            gi_case["device_ms"], gi_replayed = device_ms(torch, lambda: g_inv(z, *args))
            bundle["bit_identical_in_graph_replay"] = all(map(torch.equal, replayed, got))
            gi_case["bit_identical_in_graph_replay"] = bool(torch.equal(gi_replayed, gi_k))
            check(bundle["bit_identical_in_graph_replay"]
                  and gi_case["bit_identical_in_graph_replay"],
                  f"metric_bundle or g_inv: a graph replay differs from the eager launch at {label}")
            gi_case["plain_ms"] = time_ms(torch, lambda: g_inv_ref(z, *args), 10)
            gi_case["bound_ms"], gi_case["bound_by"] = bound_ms(
                nbytes(z, c, m, gi_k), bundle_flops(b, k, False))
        cases["metric_bundle"].append(bundle)
        cases["g_inv"].append(gi_case)

    def record(name, source, replaces, main):
        timed = [c for c in cases[name] if "ms" in c]
        rec = next(c for c in timed if c["shape"].startswith(main))
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": rec["shape"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
            "device_ms": rec["device_ms"],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms_by_shape": {c["shape"]: c["ms"] for c in timed},
            "device_ms_by_shape": {c["shape"]: c["device_ms"] for c in timed},
            "geometry_by_shape": {c["shape"]: c["geometry"] for c in timed},
            "plain_ms_by_shape": {c["shape"]: c["plain_ms"] for c in timed},
            "bound_ms_by_shape": {c["shape"]: c["bound_ms"] for c in timed},
        }

    tol = (f"kernel vs plain: |err| <= atol + rtol*|plain| with (rtol, atol) {BUNDLE_TOL}; vs "
           f"fp64: each output's error at most {BUNDLE_FP64_FACTOR}x the plain fp32 version's, or "
           f"{BUNDLE_FP64_RTOL} of its scale; L upper triangle 0, G bitwise symmetric; "
           f"bit-identical in a CUDA-graph replay")
    # the main path's banks: the hybrid model's K=200 metric (the geodesic
    # posterior's G) and the default model's K=50 metric (its evaluation step)
    bundle_rec = record("metric_bundle", "rlvae_tpu_torch/csrc/metric_bundle.cu",
                        "rlvae_tpu/ops/metric_kernels.py:657", "metric.npz")
    bundle_rec["tolerance"] = tol
    gi_rec = record("g_inv", "rlvae_tpu_torch/csrc/metric_bundle.cu",
                    "rlvae_tpu/ops/metric_kernels.py:618", "metric_T0.7")
    gi_rec["tolerance"] = (f"kernel vs plain: |err| <= 1e-6 + 1e-5*|plain|; bitwise equal to the "
                           f"metric bundle's G^-1 output; bit-identical in a CUDA-graph replay")
    return {"metric_bundle": (bundle_rec, cases["metric_bundle"]),
            "g_inv": (gi_rec, cases["g_inv"])}


def partials_flops(b: int, k: int, d: int = 16) -> float:
    """FLOP of the HMC partials: per row and centroid, d^2 (3d), the
    weighted sum of M (2d^2), the weighted differences (2d) and their
    contraction with M (2d^2); 1104 at d=16."""
    return b * k * (3 * d + 2 * d * d + 2 * d + 2 * d * d)


def partials_banks(torch, dev):
    """(label, centroids, matrices, inv_t2) on ``dev``: the banks of
    :func:`metric_banks` and the padded K=37 bank of :func:`padded_bank`."""
    out = [(label, torch.tensor(c, device=dev), torch.tensor(m, device=dev), 1.0 / t ** 2)
           for label, c, m, t, _ in metric_banks()]
    label37, _, padded = padded_bank(dev)
    out.append((label37, padded.centroids, padded.matrices, 1.0 / padded.temperature ** 2))
    return out


def run_partials_checks(torch, dev):
    """The HMC partials against their plain fp32 version and an fp64
    evaluation at each bank of :func:`partials_banks` and B = 64, 37, 1 and
    1000 (the last two rows of a batch far from every centroid);
    bit-identical on relaunch and in a CUDA-graph replay; device time per
    launch of every case, CUDA-event time of each bank at B=64."""
    from rlvae_tpu_torch.ops.metric_kernels import (
        hmc_partials,
        hmc_partials_ref,
        launch_hmc_geometry,
    )

    rng = np.random.default_rng(8)
    cases = []
    for label, c, m, inv_t2 in partials_banks(torch, dev):
        k_real = 37 if "padded" in label else c.shape[0]
        for b in PARTIALS_BATCHES:
            zn = c[:k_real].cpu().numpy()[rng.integers(0, k_real, size=b)]
            zn = zn + 0.05 * rng.normal(size=zn.shape)
            if b > 1:
                zn[-2:] += 100.0
            z = torch.tensor(zn, dtype=torch.float32, device=dev)
            got = hmc_partials(z, c, m, inv_t2)
            again = hmc_partials(z, c, m, inv_t2)
            plain = hmc_partials_ref(z, c, m, inv_t2)
            want = hmc_partials_ref(z.double(), c.double(), m.double(), inv_t2)
            torch.cuda.synchronize()
            err, ok = {}, True
            for name, k_out, rerun, p_out, e_out in zip(("gi_part", "v"), got, again, plain, want):
                ke = float((k_out.double() - e_out).abs().max())
                pe = float((p_out.double() - e_out).abs().max())
                scale = float(e_out.abs().max())
                ok = (ok and bool(torch.equal(k_out, rerun))
                      and bool(torch.all((k_out - p_out).abs()
                                         <= PARTIALS_TOL[name] * p_out.abs().clamp_min(1.0)))
                      and ke <= max(IAF_FP64_FACTOR * pe, PARTIALS_FP64_RTOL * scale))
                err[name] = {"kernel_vs_plain_abs": float((k_out - p_out).abs().max()),
                             "kernel_vs_fp64_abs": ke, "plain_vs_fp64_abs": pe,
                             "fp64_scale": scale}
            if b > 1:  # the far rows: every weight underflows
                ok = ok and bool(torch.all(got[0][-2:] == 0) and torch.all(got[1][-2:] == 0))
            if "padded" in label:  # the padded centroids add exact zeros
                unpadded = hmc_partials(z, c[:37].contiguous(), m[:37].contiguous(), inv_t2)
                ok = (ok and bool(torch.equal(unpadded[0], got[0]))
                      and bool(torch.equal(unpadded[1], got[1])))
            dms, replayed = device_ms(torch, lambda: hmc_partials(z, c, m, inv_t2))
            ok = ok and bool(torch.equal(replayed[0], got[0]) and torch.equal(replayed[1], got[1]))
            shape = f"{label},B={b}"
            check(ok, f"hmc_partials disagrees at {shape}: {err}")
            case = {"shape": shape, "ok": ok, "errors": err, "bit_identical_on_relaunch": True,
                    "bit_identical_in_graph_replay": True,
                    "geometry": list(launch_hmc_geometry(b, c.shape[0], dev)),
                    "device_ms": dms,
                    "max_abs_err": max(e["kernel_vs_plain_abs"] for e in err.values())}
            if b == SERVE_BATCH:
                case["ms"] = time_ms(torch, lambda: hmc_partials(z, c, m, inv_t2), 20)
                case["plain_ms"] = time_ms(torch, lambda: hmc_partials_ref(z, c, m, inv_t2), 10)
                case["bound_ms"], case["bound_by"] = bound_ms(
                    nbytes(z, c, m, *got), partials_flops(b, c.shape[0]))
            cases.append(case)
    timed = [c for c in cases if "ms" in c]
    main = next(c for c in timed if c["shape"].startswith("metric_T0.7"))
    record = {
        "name": "hmc_partials", "route": "cuda",
        "source": "rlvae_tpu_torch/csrc/hmc_partials.cu",
        "replaces": "rlvae_tpu/ops/metric_kernels.py:886",
        "shape": main["shape"], "ms": main["ms"], "plain_ms": main["plain_ms"],
        "device_ms": main["device_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms_by_shape": {c["shape"]: c["ms"] for c in timed},
        "device_ms_by_shape": {c["shape"]: c["device_ms"] for c in cases},
        "plain_ms_by_shape": {c["shape"]: c["plain_ms"] for c in timed},
        "bound_ms_by_shape": {c["shape"]: c["bound_ms"] for c in timed},
        "tolerance": (f"kernel vs plain: |err| <= {PARTIALS_TOL} * max(1, |plain|); vs fp64: "
                      f"at most {IAF_FP64_FACTOR}x the plain fp32 version's error, or "
                      f"{PARTIALS_FP64_RTOL} of scale; bit-identical on relaunch and in a "
                      f"CUDA-graph replay; far rows 0; the padded bank bit-identical to the "
                      f"unpadded one"),
    }
    return record, cases


def pretrained_decoder(dev):
    """The fast preset's decoder with the pretrained weights, on ``dev``."""
    from rlvae_tpu_torch.convert import load_pretrained_net
    from rlvae_tpu_torch.nets.registry import create_decoder

    dec = create_decoder((3, 64, 64), 16, {"architecture": "mlp", "out_dtype": "bfloat16"})
    load_pretrained_net(dec, PRETRAINED / "decoder.npz")
    return dec.to(dev).requires_grad_(False)


def decode_inputs(torch, dec, m: int, n: int, seed: int):
    """(h, W, b, x, rw) as the fast train step gives them to decode+MSE: h the
    decoder's hidden layer (bf16) at latents drawn from N(0, I), W [N, 512]
    and b its output layer (the first N units), x targets in [0, 1], rw = 1/B
    with rows 3 and 4 at 0 (a masked frame)."""
    dev = dec.out.weight.device
    rng = np.random.default_rng(seed)
    z = torch.tensor(rng.normal(size=(m, 16)), dtype=torch.float32, device=dev)
    rw = np.full((m,), 1.0 / TRAIN_BATCH, np.float32)
    rw[3:5] = 0.0
    return (dec.hidden(z), dec.out.weight[:n].contiguous(), dec.out.bias[:n].contiguous(),
            torch.tensor(rng.uniform(size=(m, n)), dtype=torch.float32, device=dev),
            torch.tensor(rw, device=dev))


def run_decode_checks(torch, dev):
    """decode+MSE's three entry points against their plain versions (the
    loss also against fp64) at DECODE_ROWS x DECODE_COLS, bit-identical on a
    second launch and in a CUDA-graph replay; each timed at DECODE_TIMED_ROWS
    x 12288, warm and cold."""
    from rlvae_tpu_torch.ops import recon_kernels
    from rlvae_tpu_torch.ops.recon_kernels import (
        decode_mse,
        decode_mse_bwd_dh,
        decode_mse_bwd_dw,
        decode_mse_dh_ref,
        decode_mse_dw_ref,
        decode_mse_ref,
    )

    names = ("decode_mse_fwd", "decode_mse_bwd_dh", "decode_mse_bwd_dw")
    cases = {name: [] for name in names}
    g = torch.ones((), device=dev)
    dec = pretrained_decoder(dev)
    for m in DECODE_ROWS:
        for n in DECODE_COLS:
            h, w, b, x, rw = decode_inputs(torch, dec, m, n, seed=m + n)
            args = (h, w, b, x, rw)
            loss = decode_mse(*args)
            dh = decode_mse_bwd_dh(*args, g)
            dw, db = decode_mse_bwd_dw(*args, g)
            ref = decode_mse_ref(*args)
            ref64 = decode_mse_ref(h, w.double(), b.double(), x.double(), rw.double())
            dh_p = decode_mse_dh_ref(*args, g)
            dw_p, db_p = decode_mse_dw_ref(*args, g)
            dw2, db2 = decode_mse_bwd_dw(*args, g)
            same = (torch.equal(loss, decode_mse(*args))
                    and torch.equal(dh, decode_mse_bwd_dh(*args, g))
                    and torch.equal(dw, dw2) and torch.equal(db, db2))
            replayed = graph_replay_equal(
                torch, lambda: (decode_mse(*args), decode_mse_bwd_dh(*args, g),
                                *decode_mse_bwd_dw(*args, g)), (loss, dh, dw, db))
            torch.cuda.synchronize()
            shape = f"M={m},K=512,N={n}"
            err_k, err_p = abs(float(loss) - float(ref64)), abs(float(ref) - float(ref64))
            fwd_ok = (abs(float(loss) - float(ref)) <= DECODE_LOSS_RTOL * abs(float(ref))
                      and err_k <= max(DECODE_FP64_FACTOR * err_p,
                                       DECODE_FP64_RTOL * abs(float(ref64))))
            cases["decode_mse_fwd"].append({
                "shape": shape, "ok": fwd_ok, "loss": float(loss),
                "max_abs_err": abs(float(loss) - float(ref)),
                "kernel_vs_fp64_abs": err_k, "plain_vs_fp64_abs": err_p})

            def grad_case(got, want):
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                differ = int((got != want).sum())
                return {"shape": shape, "ok": err <= DECODE_GRAD_RTOL * scale, "max_abs_err": err,
                        "scale": scale, "elements_differing": differ, "elements": got.numel()}

            h32 = h.float()
            dh_case = grad_case(decode_mse_bwd_dh(h32, w, b, x, rw, g),
                                decode_mse_dh_ref(h32, w, b, x, rw, g))
            d, ref_abs = (dh.float() - dh_p.float()).abs(), dh_p.float().abs()
            bf16_ok = bool(torch.all(d <= 2.0 ** -7 * ref_abs
                                     + DECODE_GRAD_RTOL * float(ref_abs.max())))
            dh_case["bf16_dh"] = {"max_abs_err": float(d.max()), "ok": bf16_ok,
                                  "elements_differing": int((dh != dh_p).sum())}
            dh_case["ok"] = dh_case["ok"] and bf16_ok
            dh_case["masked_rows_zero"] = bool(torch.all(dh[3:5] == 0))
            cases["decode_mse_bwd_dh"].append(dh_case)
            dw_case, db_case = grad_case(dw, dw_p), grad_case(db, db_p)
            dw_case["db"] = db_case
            dw_case["ok"] = dw_case["ok"] and db_case["ok"]
            dw_case["max_abs_err"] = max(dw_case["max_abs_err"], db_case["max_abs_err"])
            cases["decode_mse_bwd_dw"].append(dw_case)
            for name in names:
                cases[name][-1]["bit_identical_on_relaunch"] = same
                cases[name][-1]["bit_identical_in_graph_replay"] = replayed
                check(cases[name][-1]["ok"] and same and replayed
                      and cases["decode_mse_bwd_dh"][-1]["masked_rows_zero"],
                      f"{name} disagrees at {shape}: {cases[name][-1]}")

    # timing at the fast train step's rows and a larger batch, N = 12288:
    # warm (a replayed graph, W and x in L2 where they fit) and cold (each
    # launch after an L2-evicting write, that write's time subtracted)
    timed = {name: {} for name in names}
    flush = torch.empty(DECODE_FLUSH_BYTES // 4, device=dev)
    for m in DECODE_TIMED_ROWS:
        h, w, b, x, rw = args = decode_inputs(torch, dec, m, DECODE_COLS[0], seed=m)
        shape, mkn = f"M={m},K=512,N={DECODE_COLS[0]}", 2.0 * m * 512 * DECODE_COLS[0]
        ins = nbytes(h, w, b, x, rw)
        w_bf16 = w.to(torch.bfloat16)
        dp_bf16 = recon_kernels._dp(h, w, b, x, rw, torch.float32).to(torch.bfloat16)
        products = {  # cuBLAS's bf16 product alone, each entry point's last product
            "decode_mse_fwd": lambda: torch.matmul(h, w_bf16.t()),
            "decode_mse_bwd_dh": lambda: torch.matmul(dp_bf16, w_bf16),
            "decode_mse_bwd_dw": lambda: torch.matmul(dp_bf16.t(), h),
        }
        runs = {
            # (kernel, plain version, bytes of its inputs and outputs, operations)
            "decode_mse_fwd": (lambda: decode_mse(*args), lambda: decode_mse_ref(*args),
                               ins + 4, mkn),
            "decode_mse_bwd_dh": (lambda: decode_mse_bwd_dh(*args, g),
                                  lambda: decode_mse_dh_ref(*args, g),
                                  ins + 4 + nbytes(h), 2 * mkn),
            "decode_mse_bwd_dw": (lambda: decode_mse_bwd_dw(*args, g),
                                  lambda: decode_mse_dw_ref(*args, g),
                                  ins + 4 + nbytes(w, b), 2 * mkn),
        }
        for name, (kernel, plain, n_bytes, n_ops) in runs.items():
            bms, by = bound_ms(n_bytes, n_ops, PEAK_BF16_TENSOR_FLOPS)
            timed[name][shape] = {"ms": time_ms(torch, kernel, 10),
                                  "device_ms": device_ms(torch, kernel)[0],
                                  "cold_ms": cold_device_ms(torch, kernel, flush),
                                  "plain_ms": time_ms(torch, plain, 5),
                                  "bound_ms": bms, "bound_by": by,
                                  "cublas_bf16_product_ms": device_ms(torch, products[name])[0]}
    del flush

    main_shape = f"M={DECODE_TIMED_ROWS[0]},K=512,N={DECODE_COLS[0]}"
    lines = {"decode_mse_fwd": 167, "decode_mse_bwd_dh": 183, "decode_mse_bwd_dw": 192}
    tol = (f"kernel vs plain: loss rtol {DECODE_LOSS_RTOL}, each gradient within "
           f"{DECODE_GRAD_RTOL} of its largest entry (dh as its fp32 sum), the bf16 dh within one "
           f"bf16 step (2^-7) of each element plus that; loss vs fp64 at most "
           f"{DECODE_FP64_FACTOR}x "
           f"the plain fp32 version's error, or {DECODE_FP64_RTOL} relative; rows with rw=0 give "
           f"exact zeros in dh; bit-identical on relaunch and in a CUDA-graph replay")
    out = {}
    for name in names:
        t = timed[name][main_shape]
        out[name] = ({
            "name": name, "route": "cuda", "source": "rlvae_tpu_torch/csrc/decode_mse.cu",
            "replaces": f"rlvae_tpu/ops/recon_kernels.py:{lines[name]}",
            "shape": main_shape, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "device_ms": t["device_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_peaks": "products at the bf16 tensor-core peak (989 TFLOP/s), "
                           "bytes at 3.35 TB/s",
            "library_ms": None,
            "cold_ms": t["cold_ms"],
            "cublas_bf16_product_ms": t["cublas_bf16_product_ms"],
            "cublas_bf16_product": "device ms of torch.matmul in bf16 of the entry point's last "
                                   "product alone (forward [M,512]x[512,N], dh [M,N]x[N,512], "
                                   "dW [N,M]x[M,512]); no PyTorch call computes decode+MSE",
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms_by_shape": {k: v["ms"] for k, v in timed[name].items()},
            "device_ms_by_shape": {k: v["device_ms"] for k, v in timed[name].items()},
            "cold_ms_by_shape": {k: v["cold_ms"] for k, v in timed[name].items()},
            "plain_ms_by_shape": {k: v["plain_ms"] for k, v in timed[name].items()},
            "bound_ms_by_shape": {k: v["bound_ms"] for k, v in timed[name].items()},
            "cublas_bf16_product_ms_by_shape": {k: v["cublas_bf16_product_ms"]
                                                for k, v in timed[name].items()},
            "tolerance": tol,
        }, cases[name])
    return out


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def run_serve(torch):
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig

    t_load = time.perf_counter()
    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0)
    check(manager.device.type == "cuda", f"manager on {manager.device}")
    load_s = time.perf_counter() - t_load
    rng = np.random.default_rng(2)
    seqs = rng.uniform(size=(N_RECONSTRUCT, 8, 3, 64, 64)).astype(np.float32)
    frames = seqs[:N_ENCODE, 0]
    latents = rng.normal(size=(N_DECODE, 16)).astype(np.float32)

    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(1, 2, 4, 8, 16, 32, 64)))
    results, errors = {}, []
    try:
        # every (op, bucket) once, so the stats below are of a warm engine
        engine.warmup({"reconstruct": seqs[0], "encode": frames[0], "decode": latents[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        t_serve = time.perf_counter()

        def client(tid: int) -> None:
            try:
                idx = range(tid, N_RECONSTRUCT, N_THREADS)
                futs = {i: engine.submit("reconstruct", seqs[i]) for i in idx}
                for i, f in futs.items():
                    results[i] = f.result(timeout=60)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(N_THREADS)]
        for t in threads:
            t.start()
        enc = [engine.submit("encode", f) for f in frames]
        dec = [engine.submit("decode", z) for z in latents]
        enc_out = [f.result(timeout=60) for f in enc]
        dec_out = [f.result(timeout=60) for f in dec]
        for t in threads:
            t.join(timeout=120)
        serve_s = time.perf_counter() - t_serve
        launches = launch_counts()
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(not any(t.is_alive() for t in threads), "a client thread did not finish")
    if errors:
        raise errors[0]
    check(sorted(results) == list(range(N_RECONSTRUCT)), "missing reconstruct results")
    for r in results.values():
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad reconstruct result")
    check(all(e.shape == (16,) and np.isfinite(e).all() for e in enc_out), "bad encode result")
    check(all(x.shape == (3, 64, 64) and np.isfinite(x).all() for x in dec_out), "bad decode result")
    check(launches["chol_bundle"] > 0 and launches["iaf_chain_fwd"] > 0,
          f"the serving path did not launch both kernels: {launches}")
    check(launches["chol_bundle"] == 2 * launches["iaf_chain_fwd"],
          f"expected 2 chol-bundle launches per IAF-chain launch: {launches}")
    check(all(launches[k] == 0 for k in ("iaf_chain_bwd", "hmc_terms", "metric_bundle", "g_inv")),
          f"reconstruct launched the backward, the HMC terms or a metric-bundle kernel: "
          f"{launches}")

    # one B=64 forward on the card vs the same model on the CPU (plain versions)
    x = seqs[:SERVE_BATCH]
    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, 16)), dtype=torch.float32)
    out_gpu = manager.forward(x, eps=eps.to(manager.device))
    torch.cuda.synchronize()
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    out_cpu = cpu.forward(x, eps=eps)
    compare = compare_forward(torch, out_gpu, out_cpu)
    return {"launches": launches, "stats": stats, "serve_s": serve_s, "load_s": load_s,
            "requests": {"reconstruct": N_RECONSTRUCT, "encode": N_ENCODE, "decode": N_DECODE},
            "threads": N_THREADS, "cuda_vs_cpu": compare,
            "forward_b64": profile_forward(torch, manager, x, {"eps": eps.to(manager.device)}),
            "generate_official": serve_generate(torch, manager)}


# A row of a batched generate against the same seed generated alone on the
# card: the draws and the chain are per row, but the decoder's bf16 products
# at another batch size may round apart (a bf16 step is 2^-8 relative).
GEN_ROW_TOL = {"mean_abs": 1e-4, "max_abs": 2e-2}


def serve_generate(torch, manager):
    """The engine's ``generate`` op with the official chain: concurrent seeds
    coalesced into one bucket, and a lone request padded to it."""
    from rlvae_tpu_torch import BatchingEngine, ServeConfig

    bucket = len(SERVE_SEEDS)
    single = {s: manager.sample_random(1, "official", seed=s)[0] for s in set(SERVE_SEEDS)}
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(bucket,), max_wait_ms=2000),
                                         generate_method="official")
    try:
        t0 = time.perf_counter()
        futs = [engine.submit("generate", np.uint32(s)) for s in SERVE_SEEDS]
        rows = [f.result(timeout=120) for f in futs]
        batch_s = time.perf_counter() - t0
        batches = engine.stats_snapshot()["batches"]
        lone = engine.run("generate", np.uint32(SERVE_SEEDS[1]), timeout=120)
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(batches == 1, f"the {bucket} generate requests took {batches} dispatches")
    check(np.array_equal(rows[0], rows[2]), "the duplicate seeds' rows differ in one batch")
    errs = []
    for s, row in list(zip(SERVE_SEEDS, rows)) + [(SERVE_SEEDS[1], lone)]:
        check(row.shape == (8, 3, 64, 64) and np.isfinite(row).all(), "bad generate row")
        d = np.abs(row - single[s])
        errs.append({"seed": s, "mean_abs": float(d.mean()), "max_abs": float(d.max())})
        check(errs[-1]["mean_abs"] <= GEN_ROW_TOL["mean_abs"]
              and errs[-1]["max_abs"] <= GEN_ROW_TOL["max_abs"],
              f"generate row of seed {s} differs from sample_random(1, seed): {errs[-1]}")
    return {"seeds": list(SERVE_SEEDS), "batch_s": batch_s, "rows_vs_single": errs,
            "tolerance": GEN_ROW_TOL, "duplicate_rows_bit_identical": True,
            "stats": {k: v for k, v in stats.items() if not k.endswith("_hist")}}


def profile_forward(torch, manager, x, noise):
    """Warm B=64 forward: ms from CUDA events (device-side, inputs already
    on the card), ``reconstruct`` ms on the host clock (upload and copy-back
    included), and one profiled forward's device time by kernel."""
    xd = torch.from_numpy(x).to(manager.device)
    fwd_ms = time_ms(torch, lambda: manager.forward(xd, noise=noise), 5)
    host = []
    for _ in range(5):
        t = time.perf_counter()
        manager.reconstruct(x)
        host.append((time.perf_counter() - t) * 1e3)
    busy_ms, kernels = device_time_by_kernel(torch, lambda: manager.forward(xd, noise=noise))
    return {"forward_ms": fwd_ms, "reconstruct_host_ms_median": float(np.median(host)),
            "profiled_device_busy_ms": busy_ms, "n_kernel_names": len(kernels),
            "top_kernels": kernels[:10]}


def device_time_by_kernel(torch, fn):
    """One profiled call of ``fn``: (device-busy ms, [{name, us, calls}] by
    kernel, largest first), from ``torch.profiler``'s self device times."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower():
            kernels.append({"name": evt.key[:80], "us": float(us), "calls": int(evt.count)})
    kernels.sort(key=lambda k: -k["us"])
    return sum(k["us"] for k in kernels) / 1e3, kernels


# End-to-end tolerances, card vs CPU.  The nets run bf16 activations, which
# the two devices may round at other places (a bf16 step is 2^-8 relative);
# the reference-init flows then scale the latent ~20x per transition, so
# everything after z0 is compared as aggregates relative to its own scale.
E2E_TOL = {
    "mu": 1e-3, "log_var": 1e-3,        # abs, bf16 encoder
    "z0": 1e-3,                          # abs, mu + L eps
    "kld_loss": 1e-3,                    # rel
    "z_rel": 1e-3,                       # |dz| / max|z| per time step
    "recon_mean_abs": 1e-4,              # mean |d recon|, pixels in [0, 1]
    "recon_loss": 1e-3, "flow_loss": 1e-3, "loss": 1e-3,  # rel
}


def compare_forward(torch, a, b, tolerances=E2E_TOL):
    a = {k: v.float().cpu() for k, v in a.items()}
    b = {k: v.float() for k, v in b.items()}
    for k, v in a.items():
        check(bool(torch.isfinite(v).all()), f"non-finite {k} on the card")
    rel = lambda k: float((a[k] - b[k]).abs() / b[k].abs().clamp_min(1e-12))
    z_scale = b["z"].abs().amax(dim=(0, 2)).clamp_min(1e-12)
    got = {
        "mu": float((a["mu"] - b["mu"]).abs().max()),
        "log_var": float((a["log_var"] - b["log_var"]).abs().max()),
        "z0": float((a["z"][:, 0] - b["z"][:, 0]).abs().max()),
        "kld_loss": rel("kld_loss"),
        "z_rel": float(((a["z"] - b["z"]).abs().amax(dim=(0, 2)) / z_scale).max()),
        "recon_mean_abs": float((a["recon_x"] - b["recon_x"]).abs().mean()),
        "recon_loss": rel("recon_loss"), "flow_loss": rel("flow_loss"), "loss": rel("loss"),
    }
    for k, tol in tolerances.items():
        check(got[k] <= tol, f"card vs CPU forward: {k} = {got[k]} > {tol}")
    return {"errors": got, "tolerances": tolerances,
            "recon_max_abs": float((a["recon_x"] - b["recon_x"]).abs().max())}


# A trained bf16 MLP encoder, card vs CPU.  Each hidden activation is an
# fp32 sum rounded to bf16, and where that sum lies next to a bf16 boundary
# the two devices round it to neighbouring values (a flip of one bf16
# step), which the heads carry into mu as that step times a weight: an
# H100 (700 W) read a trained default model's mu 9.5e-7 off the CPU's, and
# 5.4e-3 and 5.8e-3 in runs with a flip.  So the encoder is replayed layer
# by layer from the card's input to each layer (every activation within
# one bf16 step of the CPU's, the flips counted; the fp32 heads within
# ENCODER_HEAD_TOL of max(1, |.|)), and the rest of the forward runs on the
# CPU from the card's encodings at the caller's tolerances.
ENCODER_HEAD_TOL = 1e-5


def encoder_replay(torch, encoder, cpu, x0):
    """The MLP ``encoder`` (on the card) on frames ``x0``, each layer
    replayed by ``cpu`` (its weights on the CPU) from the card's input to
    it; returns the flips and the heads' errors."""
    from rlvae_tpu_torch.nets.layers import dense

    h, flips, worst = x0.reshape(x0.shape[0], -1), 0, 0.0
    with torch.no_grad():
        for i in range(len(encoder.hidden_dims)):
            a = torch.relu(dense(getattr(encoder, f"hidden_{i}"), h, encoder.dtype))
            b = torch.relu(dense(getattr(cpu, f"hidden_{i}"), h.cpu(), cpu.dtype)).float()
            # one step at the larger of the two; at 2^-8 at least, where an
            # fp32 sum next to zero may take the ReLU's other side
            d, top = (a.float().cpu() - b).abs(), torch.maximum(a.float().cpu().abs(), b.abs())
            step = torch.finfo(encoder.dtype).eps * torch.exp2(
                torch.floor(torch.log2(top.clamp_min(2 ** -8))))
            check(bool((d <= step).all()),
                  f"encoder layer {i}: card vs CPU beyond one {encoder.dtype} step")
            flips += int((d > 0).sum())
            worst = max(worst, float(d.max()))
            h = a
        heads = {}
        for name, key in (("embedding", "mu"), ("log_var", "log_var")):
            a = dense(getattr(encoder, name), h, torch.float32).cpu()
            b = dense(getattr(cpu, name), h.cpu(), torch.float32)
            heads[key] = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
            check(heads[key] <= ENCODER_HEAD_TOL,
                  f"encoder {key} from the card's hidden layer: card vs CPU {heads[key]}")
    return {"hidden_flips": flips, "hidden_max_abs": worst, "heads_max_scaled": heads,
            "activations": int(x0.shape[0]) * sum(encoder.hidden_dims)}


def compare_trained_forward(torch, card, cpu, seqs, eps, tolerances=E2E_TOL):
    """A trained model's forward on the card (``card``, a ModelManager)
    against ``cpu`` (the same weights on the CPU) with posterior noise
    ``eps``: a bf16 MLP encoder replayed by :func:`encoder_replay`, the
    rest from the card's encodings; any other encoder as
    :func:`compare_forward`.  Returns (the errors, the card's output, the
    CPU's)."""
    from rlvae_tpu_torch.nets.mlp import MLPEncoder

    out_card = card.forward(seqs, eps=eps.to(card.device))
    encoder = card.model.encoder
    if not (isinstance(encoder, MLPEncoder) and encoder.dtype == torch.bfloat16):
        out_cpu = cpu.forward(seqs, eps=eps)
        return compare_forward(torch, out_card, out_cpu, tolerances), out_card, out_cpu
    x0 = torch.from_numpy(np.ascontiguousarray(seqs[:, 0])).to(card.device)
    with torch.no_grad():
        enc = card.model.encode(x0)
    check(torch.equal(enc["embedding"], out_card["mu"]), "the encoder's mu differs from the forward's")
    replay = encoder_replay(torch, encoder, cpu.model.encoder, x0)
    enc_card = {k: v.float().cpu() for k, v in enc.items()}
    cpu.model.encode = lambda _x0, *_: enc_card
    try:
        out_cpu = cpu.forward(seqs, eps=eps)
    finally:
        del cpu.model.encode
    return ({**compare_forward(torch, out_card, out_cpu, tolerances), "encoder_replay": replay},
            out_card, out_cpu)


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

# Card step vs the same step replayed on the CPU from the card's weights and
# optimizer state just before it.  The nets run bf16 activations, which the
# two devices round at other places (2^-8 relative per rounding), and
# gradients are compared relative to each tensor's largest entry.  At the
# presets' reference flow init each density-direction transition scales
# the latent ~20x, and there the step's gradients are ill-conditioned in
# any precision under fp64.  `python3 chip_smoke.py --replay-witness` on
# an H100 (700 W), at the native loader's batches, 3 steps: the default
# model's step-1 gradients read 1.9e-3 card vs CPU with bf16 nets and 0.26
# with fp32 nets, where the card's lie 7.7e-2 of scale from an fp64 step's
# and the CPU's 0.44; the geodesic hybrid 0.64 (bf16; card 56 and CPU 113
# of scale from fp64) and 2.3e-2 (fp32; both 1.0); at 5 steps' data the
# default read 4.3e-2 in bf16.  At the near-identity init (log-sigma bias
# 0) the same replays read 1.3e-3 (bf16) and 1.0e-6 (fp32), 8.1e-7 and
# 1.1e-6 on the hybrid, the fp32 steps 1e-6 from fp64 on both devices.
# So a reference-init run gates its losses, reports grad_norm and the
# card-vs-CPU gradients, and holds the card's step-1 gradients to an fp64
# step (fp64_grads): no farther from it than FP64_GRAD_FACTOR times the
# CPU's, or within TRAIN_TOL["grad_rel"] of its scale; a near-identity run
# of the same path (GRAD_WITNESS_STEPS) gates all three card vs CPU.
GRAD_WITNESS_STEPS = 1
FP64_GRAD_FACTOR = IAF_FP64_FACTOR
TRAIN_TOL = {
    "loss_rel": 1e-3,       # loss, recon_loss, kld_loss, flow_loss, every step
    # the nets' weight gradients come out of bf16 products: one bf16 step is
    # 2^-8 = 3.9e-3 relative, and the two devices round some entries a step
    # or two apart
    "grad_norm_rel": 2e-2,  # every step
    "grad_rel": 2e-2,       # step 1, each parameter's gradient vs its largest entry
}


def _wrappers():
    from rlvae_tpu_torch.ops.iaf_kernels import iaf_chain_bwd, iaf_chain_fwd
    from rlvae_tpu_torch.ops.metric_kernels import (
        chol_bundle,
        g_inv,
        hmc_partials,
        hmc_terms,
        metric_bundle,
    )
    from rlvae_tpu_torch.ops.recon_kernels import decode_mse, decode_mse_bwd_dh, decode_mse_bwd_dw

    return {"chol_bundle": chol_bundle, "iaf_chain_fwd": iaf_chain_fwd,
            "iaf_chain_bwd": iaf_chain_bwd, "hmc_terms": hmc_terms,
            "metric_bundle": metric_bundle, "g_inv": g_inv, "decode_mse_fwd": decode_mse,
            "decode_mse_bwd_dh": decode_mse_bwd_dh, "decode_mse_bwd_dw": decode_mse_bwd_dw,
            "hmc_partials": hmc_partials}


def launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def sequential_bwd_launches() -> int:
    """Launches of the IAF-chain backward in its sequential mode, a running
    total: :func:`zero_launch_counts` leaves it, so a phase reads a
    difference."""
    return _wrappers()["iaf_chain_bwd"].sequential_launches


def zero_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def expected_launches(**nonzero):
    """A full launch-count dict: the named counts, every other kernel 0."""
    return {**{name: 0 for name in _wrappers()}, **nonzero}


def run_train(torch, model_config=None, steps: int = TRAIN_STEPS, per_step=None, dev=None):
    """``steps`` Trainer steps of ``model_config`` (the default preset) at
    B=16 with one validation pass, in a temporary run directory;
    ``per_step`` is the launch count every step must show (the default
    model's: chol-bundle 2, IAF-chain forward and backward 1 each); step 1
    also against :func:`fp64_grads`.  Then GRAD_WITNESS_STEPS steps at the
    near-identity flow init, whose gradients are gated card vs CPU
    (``near_identity``; its launches apart)."""
    from rlvae_tpu_torch.models import PRESETS

    model_config = model_config or PRESETS["riemannian_flow_vae"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
        out = _train_and_replay(torch, run_dir, model_config, steps, per_step, dev, fp64=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
        out["near_identity"] = _train_and_replay(
            torch, run_dir, {**model_config, "flow_log_var_bias_init": 0.0},
            GRAD_WITNESS_STEPS, per_step, dev, witness=True)
    return out


def fp64_grads(torch, model_config, state, x, noise):
    """The step-1 gradients of ``model_config`` at ``state`` on batch ``x``
    and ``noise``, in float64 on the CPU (the MLP nets' products too)."""
    import torch.nn.functional as F

    from rlvae_tpu_torch.models import create_model
    from rlvae_tpu_torch.nets import mlp

    model = create_model(model_config, seed=0)
    model.load_state_dict(state)
    model.double()
    plain = mlp.dense
    mlp.dense = lambda layer, h, dtype: F.linear(h.double(), layer.weight.double(),
                                                 layer.bias.double())
    try:
        out = model(x.double(), {k: v.double() if v.is_floating_point() else v
                                 for k, v in noise.items()}, train=True)
        out.loss.backward()
    finally:
        mlp.dense = plain
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]


def _train_and_replay(torch, run_dir, model_config, steps, per_step, dev, witness=False,
                      fp64=False, timed=True):
    """The run of :func:`run_train`; ``witness``: gate the gradients card
    vs CPU and skip the timings; ``fp64``: also hold the card's and the
    CPU's step-1 gradients to :func:`fp64_grads` (gated unless ``witness``);
    ``timed=False``: skip the timings."""
    from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
    from rlvae_tpu_torch.models import create_model
    from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer, make_optimizer, make_train_step

    per_step = per_step or expected_launches(chol_bundle=2, iaf_chain_fwd=1, iaf_chain_bwd=1)
    cfg = copy.deepcopy(TRAINING_PRESETS["default"])
    cfg["data"]["batch_size"] = TRAIN_BATCH
    cfg["n_train_samples"], cfg["n_val_samples"] = steps * TRAIN_BATCH, TRAIN_BATCH
    t0 = time.perf_counter()
    data = CyclicDataModule({**CYCLIC_SPRITES, "synthetic_n_test": TRAIN_BATCH}, seed=0)
    data.setup(cfg)
    model = create_model(model_config, seed=0)
    trainer = Trainer(model, data, cfg, run_dir=run_dir, seed=0, device=dev)
    check(dev is not None or trainer.device.type == "cuda", f"trainer on {trainer.device}")
    setup_s = time.perf_counter() - t0

    # record every step: the weights and optimizer state before it, its
    # inputs, metrics and kernel launches, and step 1's gradients
    records, step = [], trainer.train_step

    def recorded_step(x, noise):
        rec = {"state": {k: v.detach().clone() for k, v in model.state_dict().items()},
               "opt": copy.deepcopy(trainer.optimizer.state_dict()), "x": x.cpu(),
               "noise": {k: v.cpu() for k, v in noise.items()}}
        before = launch_counts()
        metrics = step(x, noise)
        rec["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        if not records:
            rec["grads"] = [p.grad.detach().cpu().clone() for p in model.parameters()]
        records.append(rec)
        return metrics

    trainer.train_step = recorded_step
    torch.cuda.synchronize()
    zero_launch_counts()
    seq_before = sequential_bwd_launches()
    t_fit = time.perf_counter()
    result = trainer.fit(max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = launch_counts()
    seq_launches = sequential_bwd_launches() - seq_before
    trainer.train_step = step
    check(result["steps"] == steps == len(records), f"ran {result['steps']} steps")
    for i, rec in enumerate(records):
        check(rec["launches"] == per_step, f"step {i + 1} launched {rec['launches']}")
        check(all(np.isfinite(v) for v in rec["metrics"].values()), f"step {i + 1} not finite")
    validation = result["history"][-1]
    check(all(np.isfinite(v) for v in validation.values()), "non-finite validation")
    check(all(f"val/{k}" in validation for k in EVAL_METRIC_KEYS),
          f"validation lacks analysis metrics: {sorted(validation)}")
    # the validation pass alone launches G^{-1} (the analysis metrics at z0)
    check(launches["g_inv"] == len(result["history"]),
          f"{launches['g_inv']} G^-1 launches in {len(result['history'])} validation passes")

    # the same steps on the CPU, each from the card's state just before it
    cpu_model = create_model(model_config, seed=0)
    opt_cfg = cfg["optimizer"]
    cpu_opt = make_optimizer(cpu_model.parameters(), opt_cfg["lr"], opt_cfg["weight_decay"])
    cpu_step = make_train_step(cpu_model, cpu_opt)

    def grad_rel(grads):  # the worst parameter's |d| over its largest |g|, and its name
        return max((float((g - p.grad).abs().max() / p.grad.abs().max().clamp_min(1e-30)), name)
                   for g, (name, p) in zip(grads, cpu_model.named_parameters()))

    errors, init = [], "near-identity" if witness else "reference"
    for i, rec in enumerate(records):
        cpu_model.load_state_dict(rec["state"])
        cpu_opt.load_state_dict(rec["opt"])
        m = {k: float(v) for k, v in cpu_step(rec["x"], rec["noise"]).items()}
        err = {k: abs(rec["metrics"][k] - m[k]) / max(abs(m[k]), 1e-12)
               for k in ("loss", "recon_loss", "kld_loss", "flow_loss", "grad_norm")}
        err["loop_penalty_abs"] = abs(rec["metrics"]["loop_penalty"] - m["loop_penalty"])
        if i == 0:
            err["grad_rel"], err["grad_rel_param"] = grad_rel(rec["grads"])
            cpu_grads = [p.grad.detach().clone() for p in cpu_model.parameters()]
            rec0 = rec
        errors.append(err)
        for k in ("loss", "recon_loss", "kld_loss", "flow_loss"):
            check(err[k] <= TRAIN_TOL["loss_rel"], f"step {i + 1} {k}: card vs CPU {err[k]}")
        check(not witness or err["grad_norm"] <= TRAIN_TOL["grad_norm_rel"],
              f"step {i + 1} grad_norm at the {init} init: card vs CPU {err['grad_norm']}")
        check(err["loop_penalty_abs"] <= 1e-6, f"step {i + 1} loop_penalty differs")
    check(not witness or errors[0]["grad_rel"] <= TRAIN_TOL["grad_rel"],
          f"step-1 gradients at the {init} init: card vs CPU {errors[0]['grad_rel']}")
    if fp64:  # the card's and the CPU's step-1 gradients against float64's
        exact = fp64_grads(torch, model_config, rec0["state"], rec0["x"], rec0["noise"])
        for who, grads in (("card", rec0["grads"]), ("cpu", cpu_grads)):
            errors[0][f"{who}_vs_fp64"], errors[0][f"{who}_vs_fp64_param"] = max(
                (float((g - e).abs().max() / e.abs().max().clamp_min(1e-30)), name)
                for g, e, (name, _) in zip(grads, exact, cpu_model.named_parameters()))
        bound = max(FP64_GRAD_FACTOR * errors[0]["cpu_vs_fp64"], TRAIN_TOL["grad_rel"])
        check(witness or errors[0]["card_vs_fp64"] <= bound,
              f"step-1 gradients vs fp64: card {errors[0]['card_vs_fp64']}, CPU "
              f"{errors[0]['cpu_vs_fp64']}")
    if witness or not timed:
        return {"model_config": {"flow_log_var_bias_init": model_config.get(
                    "flow_log_var_bias_init")}, "steps": result["steps"],
                "launches": launches, "card_vs_cpu": {"errors": errors, "tolerances": TRAIN_TOL}}

    # one warm step, timed and profiled
    x = records[-1]["x"].to(trainer.device)
    noise = {k: v.to(trainer.device) for k, v in records[-1]["noise"].items()}
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, lambda: step(x, noise), 5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # before the profile: a profiler session leaves launches slower after it
    phases = step_phases(torch, model, trainer.optimizer, x, noise)
    busy_ms, kernels = device_time_by_kernel(torch, lambda: step(x, noise))
    return {
        "model": model.name, "steps": result["steps"], "batch": TRAIN_BATCH,
        "device_busy_share": busy_ms / step_ms,
        "setup_s": setup_s, "fit_s": fit_s,
        "launches": launches, "launches_per_step": records[0]["launches"],
        "iaf_chain_bwd_sequential_launches": seq_launches,
        "losses": [r["metrics"]["loss"] for r in records],
        "validation": {k: v for k, v in validation.items() if k.startswith("val/")},
        "card_vs_cpu": {"errors": errors, "tolerances": TRAIN_TOL},
        "step_ms": step_ms, "peak_memory_gb": peak_gb,
        "profiled_device_busy_ms": busy_ms, "n_kernel_names": len(kernels),
        "n_kernel_launches": sum(k["calls"] for k in kernels), "phases": phases,
        "top_kernels": kernels[:12],
    }


def step_phases(torch, model, optimizer, x, noise, reps: int = 3):
    """The parts of one train step (the body of ``make_train_step``, spelled
    out): mean ms on CUDA events and on the host clock (no synchronisation
    inside the step, so a host time close to the device time means the
    part is bound by the host's launches)."""
    names = ("forward", "backward", "grad_fill_and_norm", "adam")
    dev = {n: 0.0 for n in names}
    host = {n: 0.0 for n in names}
    params = [p for p in model.parameters() if p.requires_grad]
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        t = [0.0] * (len(names) + 1)
        torch.cuda.synchronize()
        t[0] = time.perf_counter()
        ev[0].record()
        optimizer.zero_grad(set_to_none=True)
        out = model(x, noise, train=True)
        ev[1].record()
        t[1] = time.perf_counter()
        out.loss.backward()
        ev[2].record()
        t[2] = time.perf_counter()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
        ev[3].record()
        t[3] = time.perf_counter()
        optimizer.step()
        ev[4].record()
        t[4] = time.perf_counter()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            dev[n] += ev[i].elapsed_time(ev[i + 1]) / reps
            host[n] += (t[i + 1] - t[i]) * 1e3 / reps
    return {"device_ms": dev, "host_ms": host}


# ---------------------------------------------------------------------------
# generate phase
# ---------------------------------------------------------------------------

# launches per call of sample_random_batched_seeds, by method, besides one
# IAF-chain launch each: the geodesic and centroid-aware priors take G^{-1}
# for their eigh square root; the weighted mixture runs the chol-bundle for L
# and for its logdet; basic runs 10 gradient steps through the logdet's
# Function; the chains launch the HMC terms)
GEN_LAUNCHES = {
    "geodesic": {"g_inv": 1},
    "centroid_aware": {"g_inv": 1},
    "weighted_mixture": {"chol_bundle": 2},
    "basic": {"chol_bundle": 10},
    "official": {"hmc_terms": CHAIN_LAUNCHES},
    "hmc": {"hmc_terms": CHAIN_LAUNCHES},
}


def generate_calls():
    """(method, batch) of the generate phase's main run."""
    calls = [(m, b) for m in ("geodesic", "official") for b in GEN_BATCHES]
    return calls + [(m, GEN_BATCHES[-1]) for m in ("centroid_aware", "weighted_mixture", "basic",
                                                   "hmc")]


def run_generate(torch, dev=None):
    from rlvae_tpu_torch import ModelManager, PRESETS

    t0 = time.perf_counter()
    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    load_s = time.perf_counter() - t0
    manager.sample_random_batched_seeds([0], method="official")  # warm-up
    torch.cuda.synchronize()

    calls = []
    zero_launch_counts()
    for i, (method, b) in enumerate(generate_calls()):
        seeds = list(range(100 * i, 100 * i + b))
        before = launch_counts()
        t = time.perf_counter()
        x = manager.sample_random_batched_seeds(seeds, method=method)
        host_s = time.perf_counter() - t
        got = {k: v - before[k] for k, v in launch_counts().items()}
        want = expected_launches(**GEN_LAUNCHES[method], iaf_chain_fwd=1)
        check(got == want, f"generate {method} B={b} launched {got}, expected {want}")
        check(x.shape == (b, 8, 3, 64, 64) and np.isfinite(x).all()
              and x.min() >= 0.0 and x.max() <= 1.0, f"bad generate output {method} B={b}")
        calls.append({"method": method, "batch": b, "host_ms": host_s * 1e3, "launches": got})
    launches = launch_counts()

    # one official call at B=64: host time and the profiled device time
    seeds = list(range(GEN_BATCHES[-1]))
    busy_ms, kernels = device_time_by_kernel(
        torch, lambda: manager.sample_random_batched_seeds(seeds, method="official"))
    return {
        "load_s": load_s, "calls": calls, "launches": launches,
        "official_b64": {"profiled_device_busy_ms": busy_ms, "n_kernel_names": len(kernels),
                         "n_kernel_launches": sum(k["calls"] for k in kernels),
                         "top_kernels": kernels[:10]},
        "chain_card_vs_cpu": replay_chain(torch, manager),
        "geodesic_card_vs_cpu": compare_geodesic(torch, manager),
    }


def replay_chain(torch, manager, steps: int = GEN_REPLAY_STEPS, replayed=None):
    """The official chain's first ``steps`` MCMC steps at B=64 on the
    card, one step at a time (held to ``run_prior_chain`` of that many
    steps), each step replayed on the CPU (plain terms) from the card's
    state before it with the same momenta and uniforms; with ``replayed``,
    only the first ``replayed`` steps and every later step in which the
    card accepted a row (so every accepted row is still replayed)."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.samplers import HMCConfig, mcmc_step, run_prior_chain
    from rlvae_tpu_torch.samplers.hmc import _terms_fn

    b = GEN_BATCHES[-1]
    metric = manager.model.metric
    cpu_metric = CentroidMetric(metric.centroids.cpu(), metric.matrices.cpu(),
                                metric.temperature, metric.regularization)
    cfg = HMCConfig(mcmc_steps=steps)
    gen = torch.Generator(device=manager.device).manual_seed(17)
    noise = manager.model.draw_generation_noise(b, "official", gen)
    noise = {"z0": noise["z0"], "gammas": noise["gammas"][:steps],
             "unifs": noise["unifs"][:steps]}
    terms, cpu_terms = _terms_fn(metric), _terms_fn(cpu_metric)
    with torch.no_grad():
        z_ref = run_prior_chain(terms, noise["z0"], noise["gammas"], noise["unifs"], cfg)[0]
        log_pi, grad = terms(noise["z0"])
        state = (noise["z0"], log_pi, -grad, np.float32(1.0))
        stats, accepted = _step_stats(), 0
        for step in range(cfg.mcmc_steps):
            gamma, u = noise["gammas"][step], noise["unifs"][step]
            nxt, acc, alpha = mcmc_step(terms, state, gamma, u, cfg)
            if replayed is None or step < replayed or bool(acc.any()):
                cpu_state = tuple(t.cpu() for t in state[:3]) + (state[3],)
                c_nxt, c_acc, _ = mcmc_step(cpu_terms, cpu_state, gamma.cpu(), u.cpu(), cfg)
                _compare_step(stats, acc.cpu(), alpha.cpu(), u.cpu(), nxt[0].cpu(), c_acc,
                              c_nxt[0])
            accepted += int(acc.sum())
            state = nxt
        check(torch.equal(state[0], z_ref), "the stepped chain differs from run_prior_chain")
    check(stats["flips_outside_margin"] == 0,
          f"card and CPU accept decisions differ on {stats['flips_outside_margin']} non-tie rows")
    check(stats["max_z_rel_err"] <= CHAIN_Z_RTOL,
          f"card chain vs CPU replay: z differs by {stats['max_z_rel_err']} of scale")
    check(accepted > 0, "the official chain accepted nothing")
    return {"batch": b, "card_steps": cfg.mcmc_steps, "accepted": accepted,
            "accept_rate": accepted / (b * cfg.mcmc_steps), **stats,
            "tolerance": {"z_rel": CHAIN_Z_RTOL, "accept_margin": ACCEPT_MARGIN}}


def _step_stats():
    return {"steps": 0, "ties_within_margin": 0, "flips_within_margin": 0,
            "flips_outside_margin": 0, "max_z_rel_err": 0.0}


def _compare_step(stats, acc, alpha, u, z, other_acc, other_z):
    """Fold one MCMC step's comparison into ``stats``: ties (|u - alpha| <
    ACCEPT_MARGIN), flipped decisions inside and outside the margin, and
    z's largest error relative to max(1, |z|) over rows decided alike."""
    tie = (u - alpha).abs() < ACCEPT_MARGIN
    flip = acc != other_acc
    stats["ties_within_margin"] += int(tie.sum())
    stats["flips_within_margin"] += int((flip & tie).sum())
    stats["flips_outside_margin"] += int((flip & ~tie).sum())
    same = ~flip
    if bool(same.any()):
        err = ((z - other_z).abs() / z.abs().clamp_min(1.0))[same]
        stats["max_z_rel_err"] = max(stats["max_z_rel_err"], float(err.max()))
    stats["steps"] += 1


def compare_geodesic(torch, manager):
    """One geodesic batch at B=64 from the same draws on the card and on the
    CPU: prior latents, the flows' trajectory and the decoded frames."""
    from rlvae_tpu_torch.flows.temporal import apply_temporal_flows

    b = GEN_BATCHES[-1]
    gen = torch.Generator(device=manager.device).manual_seed(23)
    noise = manager.model.draw_generation_noise(b, "geodesic", gen)
    cpu_model = copy.deepcopy(manager.model).to("cpu")
    out = []
    for model, nz in ((manager.model, noise), (cpu_model, {k: v.cpu() for k, v in noise.items()})):
        with torch.no_grad():
            z0 = model.sample_riemannian_prior(b, "geodesic", noise=nz)
            z_seq, _ = apply_temporal_flows(model.flows, z0, 8)
            x = model.generate(b, 8, "geodesic", noise=nz)
        out.append((z0.float().cpu(), z_seq.float().cpu(), x.float().cpu()))
    (z0_g, zs_g, x_g), (z0_c, zs_c, x_c) = out
    z_scale = zs_c.abs().amax(dim=(0, 2)).clamp_min(1e-12)
    got = {"z0": float((z0_g - z0_c).abs().max()),
           "z_rel": float(((zs_g - zs_c).abs().amax(dim=(0, 2)) / z_scale).max()),
           "recon_mean_abs": float((x_g - x_c).abs().mean())}
    for k in got:
        check(got[k] <= E2E_TOL[k], f"geodesic generate card vs CPU: {k} = {got[k]} > {E2E_TOL[k]}")
    return {"batch": b, "errors": got, "tolerances": {k: E2E_TOL[k] for k in got},
            "recon_max_abs": float((x_g - x_c).abs().max())}


# ---------------------------------------------------------------------------
# posterior phase
# ---------------------------------------------------------------------------


def geodesic_hybrid_config():
    """``PRESETS["hybrid_rlvae"]`` with ``sampling.method: geodesic``."""
    from rlvae_tpu_torch.models import PRESETS

    cfg = copy.deepcopy(PRESETS["hybrid_rlvae"])
    cfg["sampling"]["method"] = "geodesic"
    return cfg


def run_posterior(torch, dev=None):
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig

    t0 = time.perf_counter()
    manager = ModelManager.from_config(geodesic_hybrid_config(), seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    check(manager.model.sampling_method == "geodesic" and manager.model.metric.n_centroids == 200,
          "the geodesic hybrid model was not built")
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)

    # one B=64 reconstruct bucket through the engine, warm
    engine = BatchingEngine.from_manager(
        manager, ServeConfig(buckets=(SERVE_BATCH,), max_wait_ms=2000))
    try:
        engine.warmup({"reconstruct": seqs[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        futs = [engine.submit("reconstruct", s_) for s_ in seqs]
        rows = [f.result(timeout=60) for f in futs]
        bucket_ms = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(stats["batches"] == 1, f"the {SERVE_BATCH} requests took {stats['batches']} dispatches")
    check(counts == expected_launches(metric_bundle=1, iaf_chain_fwd=1),
          f"one geodesic reconstruct batch launched {counts}")
    for r in rows:
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad reconstruct result")

    # one B=64 forward on the card vs the same model on the CPU, same noise
    gen = torch.Generator(device=manager.device).manual_seed(3)
    noise = manager.model.draw_posterior_noise(SERVE_BATCH, gen)
    check(sorted(noise) == ["eps", "t"], f"geodesic noise {sorted(noise)}")
    before = launch_counts()["metric_bundle"]
    out_gpu = manager.forward(seqs, noise=noise)
    torch.cuda.synchronize()
    forward_launches = launch_counts()["metric_bundle"] - before
    check(forward_launches == 1, f"the forward launched G {forward_launches} times, not once")
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    out_cpu = cpu.forward(seqs, noise={k: v.cpu() for k, v in noise.items()})
    compare = compare_forward(torch, out_gpu, out_cpu)
    forward_b64 = profile_forward(torch, manager, seqs, noise)

    # training: the train phase's run and gates on the geodesic model
    train = run_train(torch, geodesic_hybrid_config(), steps=POSTERIOR_TRAIN_STEPS,
                      per_step=expected_launches(metric_bundle=1, iaf_chain_fwd=1,
                                                 iaf_chain_bwd=1), dev=dev)

    # the shipped hybrid_rlvae (enhanced posterior) reconstructs once
    shipped = ModelManager.from_config(PRESETS["hybrid_rlvae"], seed=0, device=dev)
    check(shipped.model.sampling_method == "enhanced", "the shipped preset is not 'enhanced'")
    before = launch_counts()
    x = shipped.reconstruct(seqs[:8])
    got = {k: v - before[k] for k, v in launch_counts().items()}
    check(x.shape == (8, 8, 3, 64, 64) and np.isfinite(x).all(), "bad enhanced reconstruct")
    check(got == expected_launches(chol_bundle=1, iaf_chain_fwd=1),
          f"one enhanced reconstruct launched {got}")

    totals = {k: counts[k] + train["launches"][k] + got[k] for k in counts}
    return {
        "model": "hybrid_rlvae, sampling.method=geodesic", "load_s": load_s,
        "reconstruct_bucket": {"batch": SERVE_BATCH, "host_ms": bucket_ms, "launches": counts,
                               "stats": {k: v for k, v in stats.items()
                                         if not k.endswith("_hist")}},
        "cuda_vs_cpu": compare, "forward_b64": forward_b64, "train": train,
        "enhanced_reconstruct_launches": got, "launches": totals,
        "metric_bundle_launches_per_forward": forward_launches,
    }


# ---------------------------------------------------------------------------
# fast phase
# ---------------------------------------------------------------------------


def run_fast(torch, dev=None):
    """The fast preset: Trainer steps with the fused decode+MSE loss, then one
    B=64 reconstruct bucket and a B=64 forward against the CPU."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig

    preset = PRESETS["riemannian_flow_vae_fast"]
    train = run_train(torch, preset, per_step=expected_launches(
        chol_bundle=2, decode_mse_fwd=1, decode_mse_bwd_dh=1, decode_mse_bwd_dw=1), dev=dev)

    t0 = time.perf_counter()
    manager = ModelManager.from_config(preset, seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    check(manager.model.fused_decode_mse and manager.model.flows.direction == "sampling",
          "the fast preset was not built")
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    engine = BatchingEngine.from_manager(
        manager, ServeConfig(buckets=(SERVE_BATCH,), max_wait_ms=2000))
    try:
        engine.warmup({"reconstruct": seqs[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        futs = [engine.submit("reconstruct", s_) for s_ in seqs]
        rows = [f.result(timeout=60) for f in futs]
        bucket_ms = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(stats["batches"] == 1, f"the {SERVE_BATCH} requests took {stats['batches']} dispatches")
    # serving never takes the fused loss (train=False): the posterior and the KL
    check(counts == expected_launches(chol_bundle=2),
          f"one fast reconstruct batch launched {counts}")
    for r in rows:
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad reconstruct result")

    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, 16)), dtype=torch.float32)
    out_gpu = manager.forward(seqs, eps=eps.to(manager.device))
    torch.cuda.synchronize()
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    compare = compare_forward(torch, out_gpu, cpu.forward(seqs, eps=eps))
    return {
        "model": "riemannian_flow_vae_fast", "load_s": load_s, "train": train,
        "reconstruct_bucket": {"batch": SERVE_BATCH, "host_ms": bucket_ms, "launches": counts,
                               "stats": {k: v for k, v in stats.items()
                                         if not k.endswith("_hist")}},
        "cuda_vs_cpu": compare,
        "forward_b64": profile_forward(torch, manager, seqs, {"eps": eps.to(manager.device)}),
        "launches": {k: counts[k] + train["launches"][k] for k in counts},
    }


# ---------------------------------------------------------------------------
# ep phase
# ---------------------------------------------------------------------------


def _terms_err(got, want):
    """({log_pi_abs, grad_rel}, within the HMC tolerances) of two (log pi,
    grad) pairs; grad relative to the largest |entry| of ``want``."""
    lp = float((got[0] - want[0]).abs().max())
    g = float((got[1] - want[1]).abs().max()) / float(want[1].abs().max().clamp_min(1e-30))
    return {"log_pi_abs": lp, "grad_rel": g}, lp <= HMC_LP_ATOL and g <= HMC_RTOL


def ep_terms_checks(torch, dev, metric):
    """At the model's K=50 metric and the K=20 000 bank, B=64 rows near the
    centroids: ``hmc_terms_sharded`` on the 1 x 1 mesh against ``hmc_terms``
    (B4), and the bank split into EP_SHARDS padded shards in this process
    (``hmc_partials`` on each, summed in shard order as one flat buffer, then
    the epilogue) against the whole bank."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.ops.metric_kernels import hmc_partials, hmc_terms
    from rlvae_tpu_torch.parallel import create_mesh, hmc_terms_sharded, pad_metric, shard_metric
    from rlvae_tpu_torch.parallel.metric_parallel import _finish_hmc_terms
    from rlvae_tpu_torch.samplers.hmc import LOG_EPS

    mesh = create_mesh()
    label, c, m, temp, reg = metric_banks()[-1]
    banks = [("metric_T0.7_scaled.npz(K=50)", metric),
             (label, CentroidMetric(torch.tensor(c, device=dev), torch.tensor(m, device=dev),
                                    temp, reg))]
    rng = np.random.default_rng(12)
    out = []
    for label, bank in banks:
        b, d = SERVE_BATCH, bank.centroids.shape[1]
        zn = bank.centroids.cpu().numpy()[rng.integers(0, bank.n_centroids, size=b)]
        z = torch.tensor(zn + 0.05 * rng.normal(size=zn.shape), dtype=torch.float32, device=dev)
        inv_t2 = 1.0 / bank.temperature ** 2
        whole = hmc_terms_sharded(mesh, shard_metric(mesh, bank), z)
        dense = hmc_terms(z, bank.centroids, bank.matrices, inv_t2, bank.regularization, LOG_EPS)
        padded = pad_metric(bank, EP_SHARDS)
        per, buf = padded.n_centroids // EP_SHARDS, None
        for i in range(EP_SHARDS):
            rows = slice(i * per, (i + 1) * per)
            gi, v = hmc_partials(z, padded.centroids[rows].contiguous(),
                                 padded.matrices[rows].contiguous(), inv_t2)
            part = torch.cat([gi.reshape(b, d * d), v], dim=1)
            buf = part if buf is None else buf + part
        split = _finish_hmc_terms(buf[:, : d * d].reshape(b, d, d), buf[:, d * d:],
                                  bank.regularization)
        torch.cuda.synchronize()
        vs_dense, ok_dense = _terms_err(whole, dense)
        vs_whole, ok_split = _terms_err(split, whole)
        check(ok_dense, f"hmc_terms_sharded vs hmc_terms at {label}: {vs_dense}")
        check(ok_split, f"{EP_SHARDS} shards vs the whole bank at {label}: {vs_whole}")
        out.append({"bank": label, "batch": b, "padded_k": padded.n_centroids,
                    "ep_vs_hmc_terms": vs_dense, "shards_vs_whole_bank": vs_whole})
    return out


def replay_ep_chain(torch, metric, cpu_metric, noise, cfg, z_chain, replayed=None):
    """The EP chain one MCMC step at a time on the card (the sharded terms
    on the 1 x 1 mesh), each step replayed on the CPU (the plain partials,
    the same epilogue) from the card's state before it with the same
    momenta and uniforms (with ``replayed``, as :func:`replay_chain`'s);
    the first EP_DENSE_STEPS also taken on the card with the dense
    ``hmc_terms`` (B4) from the same state."""
    from rlvae_tpu_torch.parallel import create_mesh, hmc_terms_sharded, shard_metric
    from rlvae_tpu_torch.samplers import mcmc_step
    from rlvae_tpu_torch.samplers.hmc import _terms_fn

    mesh = create_mesh()
    bank, cpu_bank = shard_metric(mesh, metric), shard_metric(mesh, cpu_metric)
    terms = {"card": lambda zz: hmc_terms_sharded(mesh, bank, zz),
             "cpu": lambda zz: hmc_terms_sharded(mesh, cpu_bank, zz),
             "dense": _terms_fn(metric)}
    stats = {k: _step_stats() for k in ("cpu", "dense")}
    accepted = 0
    with torch.no_grad():
        log_pi, grad = terms["card"](noise["z0"])
        state = (noise["z0"], log_pi, -grad, np.float32(1.0))
        for step in range(cfg.mcmc_steps):
            gamma, u = noise["gammas"][step], noise["unifs"][step]
            nxt, acc, alpha = mcmc_step(terms["card"], state, gamma, u, cfg)
            others = []
            if replayed is None or step < replayed or bool(acc.any()):
                others.append(("cpu", tuple(t.cpu() for t in state[:3]) + (state[3],),
                               gamma.cpu(), u.cpu()))
            if step < EP_DENSE_STEPS:
                others.append(("dense", state, gamma, u))
            for name, st, g, uu in others:
                o_nxt, o_acc, _ = mcmc_step(terms[name], st, g, uu, cfg)
                _compare_step(stats[name], acc.cpu(), alpha.cpu(), u.cpu(), nxt[0].cpu(),
                              o_acc.cpu(), o_nxt[0].cpu())
            accepted += int(acc.sum())
            state = nxt
    check(torch.equal(state[0], z_chain), "the stepped EP chain differs from the entry point's")
    for name, st in stats.items():
        check(st["flips_outside_margin"] == 0,
              f"EP chain vs {name}: {st['flips_outside_margin']} accept flips outside the margin")
        check(st["max_z_rel_err"] <= CHAIN_Z_RTOL,
              f"EP chain vs {name}: z differs by {st['max_z_rel_err']} of scale")
    check(accepted > 0, "the EP chain accepted nothing")
    return {"batch": int(z_chain.shape[0]), "steps": cfg.mcmc_steps, "accepted": accepted,
            "accept_rate": accepted / (z_chain.shape[0] * cfg.mcmc_steps),
            "vs_cpu_replay": stats["cpu"], "vs_dense_hmc_terms": stats["dense"],
            "tolerance": {"z_rel": CHAIN_Z_RTOL, "accept_margin": ACCEPT_MARGIN}}


def run_ep(torch, dev=None):
    """The centroid-sharded HMC path on one card: terms checks, the official
    chain through ``sample_prior_hmc_sharded`` with the launch counters
    zeroed just before and read just after, the busy share of a profiled
    short chain, the dense B4 chain on the same draws for scale, and the
    step-by-step replay."""
    from rlvae_tpu_torch.geometry import load_metric
    from rlvae_tpu_torch.geometry.metric import CentroidMetric, chol_g_inv
    from rlvae_tpu_torch.parallel import (
        all_reduce_sum,
        chol_g_inv_sharded,
        create_mesh,
        sample_prior_hmc_sharded,
        shard_metric,
    )
    from rlvae_tpu_torch.samplers import HMCConfig, draw_hmc_noise, sample_prior_hmc

    dev = dev or torch.device("cuda")
    cpu_metric = load_metric(PRETRAINED / "metric_T0.7_scaled.npz", temperature_override=3.0)
    metric = CentroidMetric(cpu_metric.centroids.to(dev), cpu_metric.matrices.to(dev),
                            cpu_metric.temperature, cpu_metric.regularization)
    terms_checks = ep_terms_checks(torch, dev, metric)

    mesh = create_mesh()
    check(mesh.shape == {"data": 1, "model": 1} and mesh.model_group is None,
          f"one process should lay out a 1 x 1 mesh, got {mesh}")
    cfg, b = HMCConfig(), SERVE_BATCH
    noise = draw_hmc_noise(metric, b, cfg, torch.Generator(device=dev).manual_seed(17))

    def short(steps):
        return {"z0": noise["z0"], "gammas": noise["gammas"][:steps],
                "unifs": noise["unifs"][:steps]}

    sample_prior_hmc_sharded(mesh, metric, b, HMCConfig(mcmc_steps=1), **short(1))  # warm-up
    torch.cuda.synchronize()
    calls_before = dict(all_reduce_sum.calls)
    zero_launch_counts()
    t = time.perf_counter()
    z, diag = sample_prior_hmc_sharded(mesh, metric, b, cfg, **noise, return_diagnostics=True)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t
    launches = launch_counts()
    calls = {a: n - calls_before[a] for a, n in all_reduce_sum.calls.items()}
    check(launches == expected_launches(hmc_partials=CHAIN_LAUNCHES),
          f"the EP chain launched {launches}")
    check(calls == {"data": cfg.mcmc_steps, "model": CHAIN_LAUNCHES},
          f"the EP chain made {calls} all-reduce calls")
    check(z.shape == (b, 16) and bool(torch.isfinite(z).all())
          and bool(torch.isfinite(diag["log_pi"]).all()), "bad EP chain output")

    # the sharded Cholesky factor: the shard's G^{-1} from the G^{-1} kernel (B7),
    # then the all-reduce, + lbd I and the factorization, against the dense
    # chol-bundle (B1) on the same rows
    g_inv_before = _wrappers()["g_inv"].launches
    l_sharded = chol_g_inv_sharded(mesh, shard_metric(mesh, metric), noise["z0"])
    torch.cuda.synchronize()
    g_inv_launched = _wrappers()["g_inv"].launches - g_inv_before
    l_dense = chol_g_inv(metric, noise["z0"])
    chol_err = (l_sharded - l_dense).abs()
    check(g_inv_launched == 1, f"chol_g_inv_sharded launched g_inv {g_inv_launched} times")
    check(bool((chol_err <= CHOL_ATOL + CHOL_RTOL * l_dense.abs()).all()),
          f"chol_g_inv_sharded disagrees with chol_g_inv: {float(chol_err.max())}")

    # the busy share of a short chain: host clock unprofiled, device time profiled
    short_cfg = HMCConfig(mcmc_steps=EP_PROFILE_STEPS)
    run_short = lambda: sample_prior_hmc_sharded(mesh, metric, b, short_cfg,  # noqa: E731
                                                 **short(EP_PROFILE_STEPS))
    torch.cuda.synchronize()
    t = time.perf_counter()
    run_short()
    torch.cuda.synchronize()
    short_ms = (time.perf_counter() - t) * 1e3
    busy_ms, kernels = device_time_by_kernel(torch, run_short)
    evals = 1 + EP_PROFILE_STEPS * (cfg.n_lf + 1)

    replay_cfg = HMCConfig(mcmc_steps=EP_REPLAY_STEPS)

    # the dense chain (B4) on the same draws, for scale
    torch.cuda.synchronize()
    t = time.perf_counter()
    z_dense = sample_prior_hmc(metric, b, cfg, **noise)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t

    return {
        "bank": "metric_T0.7_scaled.npz(K=50) at T=3.0", "mesh": mesh.shape, "batch": b,
        "terms_checks": terms_checks,
        "chain": {"mcmc_steps": cfg.mcmc_steps, "n_lf": cfg.n_lf, "host_s": chain_s,
                  "launches": launches, "all_reduce_calls": calls,
                  "accept_rate": float(diag["accept_rate"])},
        "short_chain": {"mcmc_steps": EP_PROFILE_STEPS, "host_ms": short_ms,
                        "profiled_device_busy_ms": busy_ms, "device_busy_share": busy_ms / short_ms,
                        "n_kernel_launches": sum(k["calls"] for k in kernels),
                        "kernel_launches_per_evaluation": sum(k["calls"] for k in kernels) / evals,
                        "top_kernels": kernels[:8]},
        "dense_chain": {"host_s": dense_s, "ep_over_dense": chain_s / dense_s,
                        "max_abs_z_diff_vs_ep": float((z_dense - z).abs().max())},
        "chol_g_inv_sharded": {"batch": b, "g_inv_launches": g_inv_launched,
                               "max_abs_err_vs_dense_chol_bundle": float(chol_err.max()),
                               "tolerance": f"{CHOL_ATOL} + {CHOL_RTOL}|dense|"},
        "replay": replay_ep_chain(
            torch, metric, cpu_metric, short(EP_REPLAY_STEPS), replay_cfg,
            sample_prior_hmc_sharded(mesh, metric, b, replay_cfg, **short(EP_REPLAY_STEPS))),
        "launches": launches,
    }


# ---------------------------------------------------------------------------
# dense_chain phase
# ---------------------------------------------------------------------------


def run_dense_chain(torch, dev=None):
    """The official chain (100 x 15) at B=64 through ``sample_prior_hmc`` on
    the K=20 000 bank of :func:`metric_banks`, where the HMC terms kernel
    (B4) sets the wall time: host seconds with the launch counters zeroed just
    before and read just after (1601 ``hmc_terms``), the profiled device time
    and busy share of a second run, and the first DENSE_REPLAY_STEPS MCMC
    steps replayed on the CPU (plain terms) from the card's state."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.ops.metric_kernels import launch_hmc_geometry
    from rlvae_tpu_torch.samplers import HMCConfig, draw_hmc_noise, mcmc_step, sample_prior_hmc
    from rlvae_tpu_torch.samplers.hmc import _terms_fn

    dev = dev or torch.device("cuda")
    label, c, m, temp, reg = metric_banks()[-1]
    metric = CentroidMetric(torch.tensor(c, device=dev), torch.tensor(m, device=dev), temp, reg)
    cpu_metric = CentroidMetric(torch.tensor(c), torch.tensor(m), temp, reg)
    cfg, b = HMCConfig(), SERVE_BATCH
    noise = draw_hmc_noise(metric, b, cfg, torch.Generator(device=dev).manual_seed(29))
    sample_prior_hmc(metric, b, HMCConfig(mcmc_steps=1), z0=noise["z0"],
                     gammas=noise["gammas"][:1], unifs=noise["unifs"][:1])  # warm-up
    torch.cuda.synchronize()
    zero_launch_counts()
    t = time.perf_counter()
    z = sample_prior_hmc(metric, b, cfg, **noise)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    launches = launch_counts()
    check(launches == expected_launches(hmc_terms=CHAIN_LAUNCHES),
          f"the dense K=20 000 chain launched {launches}")
    check(z.shape == (b, 16) and bool(torch.isfinite(z).all()), "bad dense chain output")
    busy_ms, kernels = device_time_by_kernel(torch, lambda: sample_prior_hmc(metric, b, cfg,
                                                                              **noise))
    terms_us = sum(k["us"] for k in kernels if "hmc_terms" in k["name"])

    # the first steps, each replayed on the CPU from the card's state before it;
    # and the same steps with every proposal accepted (u = -1), so that the
    # leapfrog endpoints are compared even where the chain rejects
    terms, cpu_terms = _terms_fn(metric), _terms_fn(cpu_metric)
    stats, proposals, accepted = _step_stats(), _step_stats(), 0
    with torch.no_grad():
        log_pi, grad = terms(noise["z0"])
        state = (noise["z0"], log_pi, -grad, np.float32(1.0))
        for step in range(DENSE_REPLAY_STEPS):
            gamma, u = noise["gammas"][step], noise["unifs"][step]
            cpu_state = tuple(t.cpu() for t in state[:3]) + (state[3],)
            for st, uu in ((proposals, torch.full_like(u, -1.0)), (stats, u)):
                nxt, acc, alpha = mcmc_step(terms, state, gamma, uu, cfg)
                c_nxt, c_acc, _ = mcmc_step(cpu_terms, cpu_state, gamma.cpu(), uu.cpu(), cfg)
                _compare_step(st, acc.cpu(), alpha.cpu(), uu.cpu(), nxt[0].cpu(), c_acc,
                              c_nxt[0])
            accepted += int(acc.sum())
            state = nxt
    check(stats["flips_outside_margin"] == 0,
          f"dense chain: card and CPU accept decisions differ on "
          f"{stats['flips_outside_margin']} non-tie rows")
    check(stats["max_z_rel_err"] <= CHAIN_Z_RTOL,
          f"dense chain vs CPU replay: z differs by {stats['max_z_rel_err']} of scale")
    return {
        "rows_moved": int((z != noise["z0"]).any(1).sum()),
        "bank": f"{label} at T={temp}", "batch": b, "mcmc_steps": cfg.mcmc_steps,
        "n_lf": cfg.n_lf, "geometry": list(launch_hmc_geometry(b, c.shape[0], dev)),
        "host_s": host_s, "profiled_device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (host_s * 1e3),
        "hmc_terms_profiled_ms": terms_us / 1e3,
        "n_kernel_launches": sum(k["calls"] for k in kernels), "top_kernels": kernels[:6],
        "launches": launches,
        "replay": {"steps": DENSE_REPLAY_STEPS, "accepted": accepted, **stats,
                   "every_proposal_accepted": proposals,
                   "tolerance": {"z_rel": CHAIN_Z_RTOL, "accept_margin": ACCEPT_MARGIN}},
    }


# ---------------------------------------------------------------------------
# checkpoint phase
# ---------------------------------------------------------------------------

CKPT_EPOCHS = 3  # epoch 0 stopped by stop_flag, epochs 1 and 2 resumed


def _timed_slots(ckpt, log):
    """Time every save and restore of a CheckpointManager: one record in
    ``log`` per call with the slot, seconds and bytes."""
    save, restore = ckpt.save, ckpt.restore

    def timed(op, fn):
        def call(slot, *args, **kwargs):
            t = time.perf_counter()
            out = fn(slot, *args, **kwargs)
            log.append({"op": op, "slot": slot, "seconds": time.perf_counter() - t,
                        "bytes": ckpt.path(slot).stat().st_size,
                        **({"map_location": str(kwargs["map_location"])}
                           if kwargs.get("map_location") is not None else {})})
            return out
        return call

    ckpt.save, ckpt.restore = timed("save", save), timed("restore", restore)
    return ckpt


def _same_bits(torch, a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _same_adam(torch, a, b) -> bool:
    return a["lr"] == b["lr"] and a["state"].keys() == b["state"].keys() and all(
        _same_bits(torch, a["state"][k], b["state"][k]) for k in a["state"])


def run_checkpoint(torch, dev=None):
    """Save, resume and reload the full-width default model in a temporary
    run directory: a Trainer at B=16 stopped by ``stop_flag`` after epoch 0,
    the ``last`` slot restored on the card and on the CPU against the live
    state, a fresh Trainer resumed for epochs 1 and 2, ``evaluate()`` on the
    ``best`` slot, then ``ModelManager.from_checkpoint(..., "best")`` behind
    the engine, against a model loaded from the slot by hand and against the
    CPU."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
    from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
    from rlvae_tpu_torch.models import create_model
    from rlvae_tpu_torch.train import (
        TRAINING_PRESETS,
        CheckpointManager,
        Trainer,
        adam_state,
        get_lr,
    )

    preset = PRESETS["riemannian_flow_vae"]
    cfg = copy.deepcopy(TRAINING_PRESETS["default"])
    cfg["data"]["batch_size"] = TRAIN_BATCH
    cfg["n_train_samples"], cfg["n_val_samples"] = TRAIN_STEPS * TRAIN_BATCH, TRAIN_BATCH
    data = CyclicDataModule({**CYCLIC_SPRITES, "synthetic_n_test": TRAIN_BATCH}, seed=0)
    data.setup(cfg)
    slots = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as run_dir:
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()

        # train with a stop after epoch 0
        trainer = Trainer(create_model(preset, seed=0), data, cfg, run_dir=run_dir, seed=0,
                          device=dev, stop_flag=lambda: len(trainer.history) >= 1)
        check(dev is not None or trainer.device.type == "cuda", f"trainer on {trainer.device}")
        ckpt = _timed_slots(trainer.checkpoints, slots)
        first = trainer.fit()
        check(first["preempted"] and first["epochs_run"] == 1 and first["steps"] == TRAIN_STEPS,
              f"the stopped fit: {({k: v for k, v in first.items() if k != 'history'})}")
        check(ckpt.exists("best") and ckpt.exists("last"), "no best or last slot")
        live = trainer.model.state_dict()
        live_opt = adam_state(trainer.model, trainer.optimizer)

        # the restored state, on the card and on the CPU
        on_card = ckpt.restore("last")
        check(all(v.device.type == trainer.device.type for v in on_card["params"].values()),
              "the last slot did not restore onto the trainer's device")
        check(_same_bits(torch, on_card["params"], live), "restored weights differ")
        check(_same_adam(torch, on_card["optimizer"], live_opt), "restored Adam state differs")
        on_cpu = ckpt.restore("last", map_location="cpu")
        check(all(v.device.type == "cpu" for v in on_cpu["params"].values()), "not on the CPU")
        check(_same_bits(torch, on_cpu["params"], live)
              and _same_adam(torch, on_cpu["optimizer"], live_opt),
              "the last slot restored on the CPU differs from the live state")
        check(on_card["epoch"] == 0 and on_card["step"] == TRAIN_STEPS, "last slot's counters")

        # resume: a fresh trainer (other seeded flows) continues at epoch 1
        resumed = Trainer(create_model(preset, seed=1), data, cfg, run_dir=run_dir, seed=0,
                          device=dev)
        _timed_slots(resumed.checkpoints, slots)
        seen, step = [], resumed.train_step

        def first_step_state(x, noise):
            if not seen:
                seen.append((adam_state(resumed.model, resumed.optimizer),
                             {k: v.clone() for k, v in resumed.model.state_dict().items()}))
            return step(x, noise)

        resumed.train_step = first_step_state
        second = resumed.fit(max_epochs=CKPT_EPOCHS, resume=True)
        resumed.train_step = step
        check(_same_adam(torch, seen[0][0], live_opt) and _same_bits(torch, seen[0][1], live),
              "the resumed run did not start from the saved weights and Adam state")
        check([h["epoch"] for h in resumed.history] == list(range(1, CKPT_EPOCHS))
              and second["steps"] == CKPT_EPOCHS * TRAIN_STEPS and not second["preempted"],
              f"resumed epochs {[h['epoch'] for h in resumed.history]}, {second['steps']} steps")
        check(second["best_val_loss"] <= first["best_val_loss"], "best val loss got worse")
        check(get_lr(resumed.optimizer) == live_opt["lr"], "the learning rate did not carry")
        counts = {float(s["step"]) for s in adam_state(resumed.model,
                                                        resumed.optimizer)["state"].values()}
        check(counts == {float(second["steps"])}, f"Adam step counts {counts}")
        before = {k: v.clone() for k, v in resumed.model.state_dict().items()}
        test_best = resumed.evaluate()
        check(_same_bits(torch, resumed.model.state_dict(), before),
              "evaluate() changed the live weights")
        check(all(np.isfinite(v) for v in test_best.values()), "non-finite evaluate()")
        fit_s = time.perf_counter() - t0

        # serve from the best slot
        t1 = time.perf_counter()
        manager = ModelManager.from_checkpoint(run_dir, preset, "best", device=dev)
        load_s = time.perf_counter() - t1
        check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
        check(all(p.device.type == manager.device.type for p in manager.model.parameters()),
              "the served weights are not on the manager's device")
        best = _timed_slots(CheckpointManager(Path(run_dir) / "checkpoints"), slots).restore(
            "best", map_location=manager.device)
        by_hand_model = create_model(preset)
        by_hand_model.load_state_dict(best["params"])
        by_hand = ModelManager(by_hand_model, device=manager.device)
        rng = np.random.default_rng(9)
        seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
        served = manager.reconstruct(seqs)
        check(served.shape == seqs.shape and np.isfinite(served).all(), "bad reconstruct")
        check(np.array_equal(served, by_hand.reconstruct(seqs)),
              "reconstruct from the checkpoint differs from the model loaded by hand")
        engine = BatchingEngine.from_manager(
            manager, ServeConfig(buckets=(SERVE_BATCH,), max_wait_ms=2000))
        try:
            engine.warmup({"reconstruct": seqs[0]})
            futs = [engine.submit("reconstruct", s_) for s_ in seqs]
            rows = [f.result(timeout=60) for f in futs]
            stats = engine.stats_snapshot()
        finally:
            engine.stop()
        check(stats["batches"] == 1, f"the {SERVE_BATCH} requests took {stats['batches']} batches")
        check(all(np.array_equal(r, served[i]) for i, r in enumerate(rows)),
              "engine rows differ from the manager's reconstruct")
        eps = torch.tensor(rng.normal(size=(SERVE_BATCH, 16)), dtype=torch.float32)
        cpu = ModelManager.from_checkpoint(run_dir, preset, "best", device="cpu")
        compare = compare_trained_forward(torch, manager, cpu, seqs, eps)[0]
        torch.cuda.synchronize()
        launches = launch_counts()
    return {
        "model": "riemannian_flow_vae", "batch": TRAIN_BATCH,
        "stopped": {k: v for k, v in first.items() if k != "history"},
        "resumed": {k: v for k, v in second.items() if k != "history"},
        "evaluate_best": test_best, "slots": slots, "fit_s": fit_s, "load_s": load_s,
        "engine": {"batches": stats["batches"], "requests": stats["requests"]},
        "cuda_vs_cpu": compare, "launches": launches,
    }


# ---------------------------------------------------------------------------
# adaptive phase
# ---------------------------------------------------------------------------

ADAPTIVE_REQUESTS, ADAPTIVE_THREADS = 64, 8
PLAN_STEPS = 12  # the planned chain's MCMC steps (sample_prior_hmc_planned)
POOL_REPLAY_ROWS = 16  # pool rows replayed on the CPU: rows are independent (64 until the
                       # viz phase joined the run: its time budget)
BUDGET_SEED, BUDGET_REPLAY_STEPS = 41, 3
NLL_BATCH, NLL_SAMPLES = 16, 50
INTERP_STEPS = 10
# card vs CPU, relative: every sample's log w and the NLL, each with the
# constant 0.5*T*C*H*W*log(2 pi) of the unit-variance Gaussian taken out (it
# is ~85% of the NLL and would hide the proposal's half log det), as the CPU
# tests hold the port to JAX; interpolated frames as the forward's
# reconstruction
NLL_RTOL = 1e-5


def planned_launches(n_lf: int, steps: int = PLAN_STEPS) -> int:
    """HMC terms launches of one planned chain: one at the start, then n_lf
    leapfrog steps and the accept test per MCMC step."""
    return 1 + steps * (n_lf + 1)


def counted_phases(torch, fn):
    """(``fn()``, one record per chain run inside it): the HMC terms
    launches of each ``run_adaptive_prior_chain`` and ``run_hmc_chain_fixed``
    call, read from the launch counter around the call, with its rows and
    steps."""
    from rlvae_tpu_torch.ops.metric_kernels import hmc_terms
    from rlvae_tpu_torch.samplers import hmc as shmc

    phases, saved = [], {n: getattr(shmc, n) for n in ("run_adaptive_prior_chain",
                                                       "run_hmc_chain_fixed")}

    def wrap(name, inner):
        def wrapped(terms, z0, gammas, *args, **kwargs):
            before = hmc_terms.launches
            out = inner(terms, z0, gammas, *args, **kwargs)
            phases.append({"chain": name, "rows": int(z0.shape[0]), "steps": int(gammas.shape[0]),
                           "hmc_terms": hmc_terms.launches - before})
            return out
        return wrapped

    try:
        for name, inner in saved.items():
            setattr(shmc, name, wrap(name, inner))
        return fn(), phases
    finally:
        for name, inner in saved.items():
            setattr(shmc, name, inner)


def calibration_draws(torch, dev, k: int, d: int = 16):
    """The draws ``calibrate_adaptive_plan`` takes from the manager's
    generator (seeded PLAN_SEED on ``dev``), in its order."""
    from rlvae_tpu_torch.inference import PLAN_SEED
    from rlvae_tpu_torch.samplers.hmc import (
        ADAPTIVE_WARMUP_A,
        adaptive_warmup_b_steps,
        draw_chain_noise,
        draw_jitters,
    )

    gen = torch.Generator(device=dev).manual_seed(PLAN_SEED)
    noise = dict(zip(("gammas_a", "unifs_a"), draw_chain_noise(gen, ADAPTIVE_WARMUP_A, k, d, dev)))
    noise.update(zip(("gammas_b", "unifs_b"),
                     draw_chain_noise(gen, adaptive_warmup_b_steps(ADAPTIVE_WARMUP_A), k, d, dev)))
    noise["cidx"] = torch.randint(0, k, (ADAPTIVE_POOL,), generator=gen, device=dev)
    noise.update(zip(("gammas_p", "unifs_p"), draw_chain_noise(gen, 128, ADAPTIVE_POOL, d, dev)))
    noise["jitters_p"] = draw_jitters(gen, 128, ADAPTIVE_POOL, device=dev)
    return noise


def replay_fixed(torch, metric, z0, eps, noise, n_lf, rows=None):
    """A fixed-eps chain stepped on the card with ``fixed_mcmc_step``, each
    step replayed on the CPU (plain terms) from the card's state before it
    with the same draws, for ``rows`` (all by default).  Returns (the card's
    final states, step stats, accepted count)."""
    from rlvae_tpu_torch.samplers.hmc import _terms_fn, fixed_mcmc_step

    terms, cpu_terms = _terms_fn(metric), _terms_fn(metric.to("cpu"))
    sel = slice(None) if rows is None else rows.to(z0.device)
    stats, accepted = _step_stats(), 0
    with torch.no_grad():
        log_pi, grad = terms(z0)
        carry = (z0, log_pi, -grad)
        for s in range(noise["gammas"].shape[0]):
            gamma, u, e = noise["gammas"][s], noise["unifs"][s], eps * noise["jitters"][s]
            nxt, acc, alpha = fixed_mcmc_step(terms, carry, gamma, u, e, n_lf)
            cpu_carry = tuple(t[sel].cpu() for t in carry)
            c_nxt, c_acc, _ = fixed_mcmc_step(cpu_terms, cpu_carry, gamma[sel].cpu(),
                                              u[sel].cpu(), e[sel].cpu(), n_lf)
            _compare_step(stats, acc[sel].cpu(), alpha[sel].cpu(), u[sel].cpu(),
                          nxt[0][sel].cpu(), c_acc, c_nxt[0])
            accepted += int(acc[sel].sum())
            carry = nxt
    check(stats["flips_outside_margin"] == 0,
          f"card and CPU accept decisions differ on {stats['flips_outside_margin']} non-tie rows")
    check(stats["max_z_rel_err"] <= CHAIN_Z_RTOL,
          f"fixed-eps chain vs CPU replay: z differs by {stats['max_z_rel_err']} of scale")
    return carry[0], stats, accepted


def replay_budget_start(torch, manager, seed):
    """The budget sampler's first BUDGET_REPLAY_STEPS MCMC steps (phase A:
    dual averaging at n_lf 5 from centroid starts) on the card, from the
    draws of ``sample_random(64, "adaptive", seed)``, each replayed on the
    CPU from the card's carry (z, log pi, -grad, x, x_bar, h_bar); the
    stepped chain is ``run_adaptive_prior_chain``'s."""
    from rlvae_tpu_torch.samplers.hmc import (
        ADAPTIVE_NLF_A,
        ADAPTIVE_TARGET_A,
        ADAPTIVE_WARMUP_A,
        DualAveraging,
        HMCConfig,
        _terms_fn,
        adaptive_mcmc_step,
        draw_chain_noise,
        run_adaptive_prior_chain,
    )

    metric = manager.model.metric
    dev, b = manager.device, SERVE_BATCH
    gen = torch.Generator(device=dev).manual_seed(seed)
    z0 = metric.centroids[torch.randint(0, metric.n_centroids, (b,), generator=gen, device=dev)]
    gammas, unifs = draw_chain_noise(gen, ADAPTIVE_WARMUP_A, b, 16, dev)
    cfg = HMCConfig(init="centroids")
    terms, cpu_terms = _terms_fn(metric), _terms_fn(metric.to("cpu"))
    eps0 = torch.tensor(cfg.eps_lf, dtype=torch.float32, device=dev)
    da = DualAveraging(torch.log(10.0 * eps0), ADAPTIVE_TARGET_A, ADAPTIVE_WARMUP_A, True)
    cpu_da = DualAveraging(da.mu.cpu(), da.target, da.warmup, True)
    stats, da_err = _step_stats(), 0.0
    with torch.no_grad():
        log_pi, grad = terms(z0)
        log_eps0 = torch.log(eps0).expand(b)
        carry = (z0, log_pi, -grad, log_eps0, log_eps0, torch.zeros(b, device=dev))
        for t in range(BUDGET_REPLAY_STEPS):
            nxt, acc, alpha = adaptive_mcmc_step(terms, carry, gammas[t], unifs[t], t,
                                                 ADAPTIVE_NLF_A, da)
            c_nxt, c_acc, _ = adaptive_mcmc_step(cpu_terms, tuple(x.cpu() for x in carry),
                                                 gammas[t].cpu(), unifs[t].cpu(), t,
                                                 ADAPTIVE_NLF_A, cpu_da)
            _compare_step(stats, acc.cpu(), alpha.cpu(), unifs[t].cpu(), nxt[0].cpu(), c_acc,
                          c_nxt[0])
            same = acc.cpu() == c_acc
            da_err = max(da_err, float(((nxt[4].cpu() - c_nxt[4]).abs()
                                        / c_nxt[4].abs().clamp_min(1.0))[same].max()))
            carry = nxt
        zs, _ = run_adaptive_prior_chain(
            terms, z0, gammas[:BUDGET_REPLAY_STEPS], unifs[:BUDGET_REPLAY_STEPS],
            HMCConfig(init="centroids", mcmc_steps=BUDGET_REPLAY_STEPS, n_lf=ADAPTIVE_NLF_A),
            target_accept=ADAPTIVE_TARGET_A, warmup=ADAPTIVE_WARMUP_A)
    check(torch.equal(zs[-1], carry[0]),
          "the stepped phase A differs from run_adaptive_prior_chain")
    check(stats["flips_outside_margin"] == 0,
          f"budget phase A: accept decisions differ on {stats['flips_outside_margin']} "
          f"non-tie rows")
    check(stats["max_z_rel_err"] <= CHAIN_Z_RTOL,
          f"budget phase A vs CPU replay: z differs by {stats['max_z_rel_err']} of scale")
    return {"steps": BUDGET_REPLAY_STEPS, **stats, "x_bar_max_rel_err": da_err}


def hmc_hybrid_config():
    """``PRESETS["hybrid_rlvae"]`` with ``sampling.method: hmc``."""
    from rlvae_tpu_torch.models import PRESETS

    cfg = copy.deepcopy(PRESETS["hybrid_rlvae"])
    cfg["sampling"]["method"] = "hmc"
    return cfg


def run_adaptive(torch, dev=None):
    """The adaptive generation path behind the engine, at full width on the
    default preset (section 12 of the module docstring)."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
    from rlvae_tpu_torch.utils.output import ModelOutput
    from rlvae_tpu_torch.samplers.hmc import (
        ADAPTIVE_NLF_A,
        ADAPTIVE_WARMUP_A,
        HMCConfig,
        adaptive_warmup_b_steps,
        calibrate_adaptive_plan,
        planned_starts,
        sample_prior_hmc_adaptive_budget,
        sample_prior_hmc_planned,
    )

    t_phase, laps = time.perf_counter(), {}
    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    dev, model, metric = manager.device, manager.model, manager.model.metric
    check(metric.n_centroids == ADAPTIVE_CHAINS, f"the default metric has K={metric.n_centroids}")
    engine = BatchingEngine.from_manager(manager, ServeConfig(max_wait_ms=20.0),
                                         generate_method="adaptive")
    try:
        # 1. the calibration behind the engine, through the manager's cache
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        plan, phases = counted_phases(torch, lambda: manager.adaptive_plan(ADAPTIVE_POOL))
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t
        calib_counts = launch_counts()
        n_lf = plan["n_lf"]
        warm_b = adaptive_warmup_b_steps(ADAPTIVE_WARMUP_A)
        want_phases = [
            {"chain": "run_adaptive_prior_chain", "rows": ADAPTIVE_CHAINS,
             "steps": ADAPTIVE_WARMUP_A, "hmc_terms": 1 + ADAPTIVE_WARMUP_A * (ADAPTIVE_NLF_A + 1)},
            {"chain": "run_adaptive_prior_chain", "rows": ADAPTIVE_CHAINS, "steps": warm_b,
             "hmc_terms": 1 + warm_b * (n_lf + 1)},
            {"chain": "run_hmc_chain_fixed", "rows": ADAPTIVE_POOL, "steps": 128,
             "hmc_terms": 1 + 128 * (n_lf + 1)}]
        check(phases == want_phases, f"calibration phases {phases}, expected {want_phases}")
        check(calib_counts == expected_launches(hmc_terms=sum(p["hmc_terms"] for p in phases)),
              f"the calibration launched {calib_counts}")
        check(manager.adaptive_plan() is plan, "the plan was not cached")
        for key in ("eps", "pool", "pool_eps"):
            check(bool(torch.isfinite(plan[key]).all()), f"non-finite plan {key}")
        check(plan["pool"].shape == (ADAPTIVE_POOL, 16) and 2 <= n_lf <= 128, "bad plan")
        # the calibration again, profiled, on the draws calibration_draws
        # makes: device time and busy share, and the same plan bit for bit
        again = {}
        cal_noise = calibration_draws(torch, dev, metric.n_centroids)
        busy_ms, kernels = device_time_by_kernel(torch, lambda: again.update(
            calibrate_adaptive_plan(metric, HMCConfig(init="centroids"),
                                    pool_size=ADAPTIVE_POOL, noise=cal_noise)))
        b4_us = sum(k["us"] for k in kernels if "hmc_terms" in k["name"])
        laps["calibration"] = time.perf_counter() - t_phase
        check(all(torch.equal(again[k], plan[k]) for k in ("eps", "pool", "pool_eps"))
              and again["n_lf"] == n_lf, "the calibration on its own draws differs from the plan")

        # 2. generate requests, one seed each, from several threads
        engine.warmup({"generate": np.uint32(0)})
        torch.cuda.synchronize()
        zero_launch_counts()
        stats0 = engine.stats_snapshot()
        results, errors = {}, []
        t = time.perf_counter()

        def client(tid: int) -> None:
            try:
                futs = {i: engine.submit("generate", np.uint32(1000 + i))
                        for i in range(tid, ADAPTIVE_REQUESTS, ADAPTIVE_THREADS)}
                for i, f in futs.items():
                    results[i] = f.result(timeout=120)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(ADAPTIVE_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        gen_s = time.perf_counter() - t
        gen_counts = launch_counts()
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(not any(th.is_alive() for th in threads), "a generate client did not finish")
    if errors:
        raise errors[0]
    batches = stats["batches"] - stats0["batches"]
    check(sorted(results) == list(range(ADAPTIVE_REQUESTS)), "missing generate results")
    for r in results.values():
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all() and r.min() >= 0.0
              and r.max() <= 1.0, "bad adaptive generate result")
    want = expected_launches(hmc_terms=batches * planned_launches(n_lf), iaf_chain_fwd=batches)
    check(gen_counts == want, f"{batches} adaptive generate batches launched {gen_counts}, "
                              f"expected {want}")
    launches = {k: calib_counts[k] + gen_counts[k] for k in calib_counts}
    laps["generate"] = time.perf_counter() - t_phase

    # host ms of one B=64 batch, adaptive (planned) and official, in this call
    seeds = list(range(SERVE_BATCH))
    host_ms = {}
    for method in ("adaptive", "official", "adaptive", "official"):
        t = time.perf_counter()
        manager.sample_random_batched_seeds(seeds, method=method)
        host_ms.setdefault(method, []).append((time.perf_counter() - t) * 1e3)

    # 3. the planned chain of one batch, replayed on the CPU step by step
    noise = concat_rows_for(torch, manager, seeds, plan)
    z0, eps = planned_starts(metric, plan, noise["idx"])
    z_card, plan_stats, plan_acc = replay_fixed(torch, metric, z0, eps, noise, n_lf)
    with torch.no_grad():
        check(torch.equal(z_card, sample_prior_hmc_planned(metric, SERVE_BATCH, plan, noise=noise)),
              "the stepped planned chain differs from sample_prior_hmc_planned")
    # 64 of the pool's rows, from their centroid starts, with the calibration's draws
    cal = calibration_draws(torch, dev, metric.n_centroids)
    cidx = cal["cidx"]
    rows = torch.arange(0, ADAPTIVE_POOL, ADAPTIVE_POOL // POOL_REPLAY_ROWS, device=dev)
    pool_card, pool_stats, pool_acc = replay_fixed(
        torch, metric, metric.centroids[cidx], plan["eps"][cidx],
        {"gammas": cal["gammas_p"], "unifs": cal["unifs_p"], "jitters": cal["jitters_p"]},
        n_lf, rows)
    check(torch.equal(pool_card, plan["pool"]), "the stepped pool differs from the plan's pool")
    laps["replays"] = time.perf_counter() - t_phase

    # 4. the budget sampler: sample_random without the plan
    zero_launch_counts()
    t = time.perf_counter()
    x_budget = manager.sample_random(SERVE_BATCH, "adaptive", seed=BUDGET_SEED)
    budget_ms = (time.perf_counter() - t) * 1e3
    budget_counts = launch_counts()
    with torch.no_grad():
        _, diag = sample_prior_hmc_adaptive_budget(
            metric, SERVE_BATCH, HMCConfig(init="centroids"), return_chain=True,
            generator=torch.Generator(device=dev).manual_seed(BUDGET_SEED))
    n_s, steps_s = diag["n_lf_sampling"], diag["steps_sampling"]
    want = expected_launches(
        hmc_terms=(1 + ADAPTIVE_WARMUP_A * (ADAPTIVE_NLF_A + 1)) + (1 + warm_b * (n_s + 1))
        + (1 + steps_s * (n_s + 1)), iaf_chain_fwd=1)
    check(budget_counts == want, f"the budget sampler launched {budget_counts}, expected {want}")
    check(x_budget.shape == (SERVE_BATCH, 8, 3, 64, 64) and np.isfinite(x_budget).all(),
          "bad budget-sampler output")
    check(diag["leapfrog_spent"] <= 100 * 15, f"budget overspent: {diag['leapfrog_spent']}")
    budget_replay = replay_budget_start(torch, manager, BUDGET_SEED)
    laps["budget"] = time.perf_counter() - t_phase

    # 5. estimate_nll at B=16, S=50, card vs CPU
    rng = np.random.default_rng(16)
    x_nll = torch.tensor(rng.uniform(size=(NLL_BATCH, 8, 3, 64, 64)), dtype=torch.float32)
    eps_nll = torch.randn((NLL_SAMPLES, NLL_BATCH, 16),
                          generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    cpu_model = copy.deepcopy(model).to("cpu")
    zero_launch_counts()
    t = time.perf_counter()
    nll, log_w = estimate_nll_and_log_w(torch, model, x_nll.to(dev), eps_nll)
    torch.cuda.synchronize()
    nll_ms = (time.perf_counter() - t) * 1e3
    nll_counts = launch_counts()
    check(nll_counts == expected_launches(chol_bundle=1, iaf_chain_fwd=NLL_SAMPLES),
          f"estimate_nll launched {nll_counts}")
    nll_cpu, log_w_cpu = estimate_nll_and_log_w(torch, cpu_model, x_nll, eps_nll.cpu())
    log_px_const = 0.5 * x_nll[0].numel() * math.log(2 * math.pi)
    nll, log_w = nll.cpu(), log_w.cpu()
    nll_errs = {
        "log_w": float(((log_w - log_w_cpu).abs() / (log_w_cpu + log_px_const).abs()).max()),
        "nll": float(((nll - nll_cpu).abs() / (nll_cpu - log_px_const).abs()).max()),
        "nll_with_constant": float(((nll - nll_cpu).abs() / nll_cpu.abs()).max())}
    check(log_w.shape == (NLL_SAMPLES, NLL_BATCH) and bool(torch.isfinite(log_w).all())
          and bool(torch.isfinite(nll).all()), "non-finite estimate_nll on the card")
    for k in ("log_w", "nll"):
        check(nll_errs[k] <= NLL_RTOL, f"estimate_nll card vs CPU: {k} {nll_errs[k]} > {NLL_RTOL}")

    laps["nll"] = time.perf_counter() - t_phase
    # 6. the posterior HMC: one B=64 reconstruct bucket of the hmc hybrid model
    posterior = run_posterior_hmc(torch, dev)
    laps["posterior_hmc"] = time.perf_counter() - t_phase

    # 7. interpolation, card vs CPU: the CPU builds the path between the
    # card's embeddings (the encoder alone is held to the CPU at the
    # forward's mu tolerance, as for the posterior HMC) and decodes it
    cpu_manager = ModelManager(cpu_model, device="cpu")
    frames = rng.uniform(size=(2, 3, 64, 64)).astype(np.float32)
    enc_card, enc_cpu = manager.encode(frames), cpu_manager.encode(frames)
    interp = {"encoder_card_vs_cpu_max_abs": float(np.abs(enc_card.embedding
                                                          - enc_cpu.embedding).max())}
    check(interp["encoder_card_vs_cpu_max_abs"] <= E2E_TOL["mu"],
          f"interpolate encoder card vs CPU: {interp['encoder_card_vs_cpu_max_abs']}")
    cpu_manager.encode = lambda x: ModelOutput(embedding=manager.encode(x).embedding)
    for mode in ("linear", "spherical"):
        zero_launch_counts()
        got = manager.interpolate(frames[0], frames[1], INTERP_STEPS, mode)
        check(launch_counts() == expected_launches(), f"interpolate launched {launch_counts()}")
        want_x = cpu_manager.interpolate(frames[0], frames[1], INTERP_STEPS, mode)
        d = np.abs(got - want_x)
        interp[mode] = {"mean_abs": float(d.mean()), "max_abs": float(d.max())}
        check(got.shape == (INTERP_STEPS, 3, 64, 64) and np.isfinite(got).all()
              and interp[mode]["mean_abs"] <= E2E_TOL["recon_mean_abs"],
              f"interpolate {mode} card vs CPU: {interp[mode]}")

    eps_plan = plan["eps"].float().cpu()
    return {
        "model": "riemannian_flow_vae", "engine": "BatchingEngine(generate_method='adaptive')",
        "calibration": {
            "n_lf": n_lf, "eps_min": float(eps_plan.min()), "eps_max": float(eps_plan.max()),
            "eps_median": float(np.median(eps_plan.numpy())), "accept_rate": plan["accept_rate"],
            "calibration_lf": plan["calibration_lf"], "chains": plan["chains"],
            "pool": ADAPTIVE_POOL, "host_s": calib_s, "phases": phases,
            "profiled_device_busy_ms": busy_ms, "device_busy_share": busy_ms / (calib_s * 1e3),
            "hmc_terms_profiled_ms": b4_us / 1e3,
            "n_kernel_launches_profiled": sum(k["calls"] for k in kernels),
            "top_kernels": kernels[:6]},
        "generate": {"requests": ADAPTIVE_REQUESTS, "threads": ADAPTIVE_THREADS,
                     "batches": batches, "seconds": gen_s, "launches": gen_counts,
                     "hmc_terms_per_batch": planned_launches(n_lf),
                     "host_ms_b64": host_ms,
                     "stats": {k: v for k, v in stats.items() if not k.endswith("_hist")}},
        "launches": launches,
        "planned_chain_card_vs_cpu": {"batch": SERVE_BATCH, "accepted": plan_acc, **plan_stats},
        "pool_card_vs_cpu": {"rows": POOL_REPLAY_ROWS, "steps": 128, "accepted": pool_acc,
                             **pool_stats},
        "replay_tolerance": {"z_rel": CHAIN_Z_RTOL, "accept_margin": ACCEPT_MARGIN},
        "budget": {"batch": SERVE_BATCH, "host_ms": budget_ms, "launches": budget_counts,
                   "n_lf_sampling": n_s, "steps_sampling": steps_s,
                   "leapfrog_spent": diag["leapfrog_spent"],
                   "accept_rate": float(diag["accept_rate"]),
                   "eps_tuned_median": float(diag["eps_tuned"].median()),
                   "replay": budget_replay},
        "nll": {"batch": NLL_BATCH, "samples": NLL_SAMPLES, "ms": nll_ms, "launches": nll_counts,
                "nll_mean": float(nll.mean()), "log_px_constant": log_px_const,
                "card_vs_cpu_rel": nll_errs, "rtol": NLL_RTOL},
        "posterior_hmc": posterior,
        "interpolate": {"steps": INTERP_STEPS, "card_vs_cpu": interp,
                        "tolerance_mean_abs": E2E_TOL["recon_mean_abs"]},
        "seconds": time.perf_counter() - t_phase, "elapsed_s_after": laps,
    }


def estimate_nll_and_log_w(torch, model, x, eps):
    """``model.estimate_nll`` on the draws ``eps`` [S, B, D], and the log
    weights [S, B] it reduces, read at its logsumexp."""
    seen, logsumexp = {}, torch.logsumexp

    def recording(t, dim):
        seen["log_w"] = t
        return logsumexp(t, dim)

    torch.logsumexp = recording
    try:
        with torch.no_grad():
            nll = model.estimate_nll(x, eps.shape[0], noise=eps)
    finally:
        torch.logsumexp = logsumexp
    return nll, seen["log_w"]


def concat_rows_for(torch, manager, seeds, plan):
    """The planned chain's draws of a batch of seeds, each row's from its own
    generator (``sample_random_batched_seeds``' contract)."""
    from rlvae_tpu_torch.samplers import concat_rows

    return concat_rows([manager.model.draw_generation_noise(
        1, "adaptive", torch.Generator(device=manager.device).manual_seed(s), plan=plan)
        for s in seeds])


def run_posterior_hmc(torch, dev):
    """One B=64 ``reconstruct`` bucket of ``hybrid_rlvae`` with
    ``sampling.method: hmc`` behind the engine (200 HMC terms launches at
    K=200, one IAF-chain launch), and a B=64 forward held against the CPU on
    the same draws.  The sequences are frames the pretrained decoder makes
    from the metric's first 64 centroids (in-distribution: their posteriors
    lie near the centroids, where the target's gradient is not zero); the
    posterior chain of uniform-noise frames is replayed as well (their
    posteriors lie on the target's plateau, and the chain diverges)."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, ServeConfig

    manager = ModelManager.from_config(hmc_hybrid_config(), seed=0, device=dev)
    model = manager.model
    check(model.sampling_method == "hmc" and model.metric.n_centroids == 200,
          "the hmc hybrid model was not built")
    with torch.no_grad():
        frames = model.decode(model.metric.centroids[:SERVE_BATCH])["reconstruction"]
    seqs = np.repeat(frames.float().cpu().numpy()[:, None], 8, axis=1)
    engine = BatchingEngine.from_manager(
        manager, ServeConfig(buckets=(SERVE_BATCH,), max_wait_ms=2000))
    try:
        engine.warmup({"reconstruct": seqs[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        futs = [engine.submit("reconstruct", s_) for s_ in seqs]
        rows = [f.result(timeout=120) for f in futs]
        bucket_ms = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        batches = engine.stats_snapshot()["batches"]
    finally:
        engine.stop()
    check(counts == expected_launches(hmc_terms=200 * batches, iaf_chain_fwd=batches),
          f"{batches} posterior-HMC reconstruct batches launched {counts}")
    for r in rows:
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad reconstruct result")
    gen = torch.Generator(device=manager.device).manual_seed(9)
    noise = manager.model.draw_posterior_noise(SERVE_BATCH, gen)
    check(sorted(noise) == ["eps", "gammas"] and noise["gammas"].shape == (20, SERVE_BATCH, 16),
          f"posterior hmc noise {sorted(noise)}")
    out_gpu = manager.forward(seqs, noise=noise)
    torch.cuda.synchronize()
    # The CPU replays the forward stage by stage from the card's state, as the
    # chains are replayed: each of the posterior chain's 20 MCMC steps from
    # the card's z before it (the chain diverges on this encoder's
    # posteriors, exp(-log_var) up to ~6e3, in JAX as here, so only
    # per-step errors are meaningful), then the flows, decoder and losses
    # from the card's encoder output and z0 at compare_forward's tolerances.
    # The encoder alone is held to the CPU on the same frames at
    # compare_forward's mu and log_var tolerances.
    cpu_model = copy.deepcopy(manager.model).to("cpu")
    with torch.no_grad():
        x0 = torch.from_numpy(seqs[:, 0])
        enc = manager.model.encode(x0.to(dev))
        enc_card = {k: v.float().cpu() for k, v in enc.items()}
        enc_cpu = cpu_model.encode(x0)
        chain = replay_posterior_chain(torch, manager.model.metric, enc["embedding"].float(),
                                       enc["log_covariance"].float(), noise)
        noise_frames = torch.tensor(np.random.default_rng(8).uniform(size=(SERVE_BATCH, 3, 64, 64)),
                                    dtype=torch.float32, device=dev)
        enc_noise = manager.model.encode(noise_frames)
        diverging = replay_posterior_chain(torch, manager.model.metric,
                                           enc_noise["embedding"].float(),
                                           enc_noise["log_covariance"].float(), noise)
    diverging.pop("z0")
    check(torch.equal(chain.pop("z0"), out_gpu.z[:, 0]),
          "the stepped posterior chain differs from the forward's z0")
    encoder = {k: float((enc_card[k] - enc_cpu[k].float()).abs().max())
               for k in ("embedding", "log_covariance")}
    for k, tol in (("embedding", E2E_TOL["mu"]), ("log_covariance", E2E_TOL["log_var"])):
        check(encoder[k] <= tol, f"posterior-HMC encoder card vs CPU: {k} = {encoder[k]} > {tol}")
    z0_card = out_gpu.z[:, 0].float().cpu()
    cpu_model.encode = lambda _x0, *_: enc_card
    cpu_model.sample_z0 = lambda _mu, _log_var, _noise: z0_card
    out_cpu = ModelManager(cpu_model, device="cpu").forward(
        seqs, noise={k: v.cpu() for k, v in noise.items()})
    return {"model": "hybrid_rlvae, sampling.method=hmc", "batches": batches,
            "bucket_host_ms": bucket_ms, "launches": counts,
            "encoder_card_vs_cpu_max_abs": encoder, "chain_card_vs_cpu": chain,
            "noise_frames_chain_card_vs_cpu": diverging,
            "cuda_vs_cpu_from_card_z0": compare_forward(torch, out_gpu, out_cpu)}


def replay_posterior_chain(torch, metric, mu, log_var, noise):
    """The posterior chain on the card one MCMC step at a time, each step
    replayed on the CPU (plain terms) from the card's z before it with the
    same momentum; z within CHAIN_Z_RTOL of max(1, |z|).  Also the rows
    whose target gradient is not zero (off the log 1e-10 plateau) at the
    start of each step (one terms launch each, outside the counted runs)."""
    from rlvae_tpu_torch.samplers.hmc import _terms_fn, posterior_hmc_step

    terms, cpu_terms = _terms_fn(metric), _terms_fn(metric.to("cpu"))
    inv_var = torch.exp(-log_var)
    z = mu + noise["eps"] * torch.exp(0.5 * log_var)
    err, scale, off_plateau = 0.0, [], []
    for gamma in noise["gammas"]:
        off_plateau.append(int((terms(z)[1].abs().amax(1) > 0).sum()))
        nxt = posterior_hmc_step(terms, z, gamma, mu, inv_var)
        c_nxt = posterior_hmc_step(cpu_terms, z.cpu(), gamma.cpu(), mu.cpu(), inv_var.cpu())
        err = max(err, float(((nxt.cpu() - c_nxt).abs() / c_nxt.abs().clamp_min(1.0)).max()))
        scale.append(float(nxt.abs().max()))
        z = nxt
    check(err <= CHAIN_Z_RTOL, f"posterior chain vs CPU replay: z differs by {err} of scale")
    return {"steps": len(scale), "max_z_rel_err": err, "tolerance": CHAIN_Z_RTOL,
            "max_abs_z_by_step": scale, "rows_off_plateau_by_step": off_plateau, "z0": z}


# ---------------------------------------------------------------------------
# experiment phase
# ---------------------------------------------------------------------------

# the runs' sizes: full width, cut in epochs and sequences only (training
# quick: batch 4, a step record every step)
EXP_TRAIN, EXP_VAL, EXP_TEST = 32, 8, 16
EXP_CUT = [f"training.n_train_samples={EXP_TRAIN}", f"training.n_val_samples={EXP_VAL}",
           f"data.synthetic_n_test={EXP_TEST}"]
TIMER_KEYS = ("step_time_avg", "step_time_p50", "step_time_p99", "steps_per_sec")
# the kernels of the IAF chain's forward and backward, as the profiler names them
B2_B3_NAMES = ("iaf_chain_fwd_kernel", "iaf_chain_bwd_kernel")


def matplotlib_imports() -> bool:
    """Whether matplotlib imports here (the card's box has none)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def counted_trainers():
    """(runs, restore): every Trainer built until ``restore()`` appends one
    ``{"train": [...], "eval": [...]}`` to ``runs``, with each train step's
    and each evaluation batch's kernel launches, read from the counters
    around the step."""
    from rlvae_tpu_torch.train import trainer as trainer_module

    runs = []
    make_train, make_eval = trainer_module.make_train_step, trainer_module.make_eval_step

    def counting(kind, step):
        def counted(*args, **kwargs):
            before = launch_counts()
            out = step(*args, **kwargs)
            runs[-1][kind].append({k: v - before[k] for k, v in launch_counts().items()})
            return out
        return counted

    def make_train_step(*args, **kwargs):
        runs.append({"train": [], "eval": []})
        return counting("train", make_train(*args, **kwargs))

    def make_eval_step(*args, **kwargs):
        return counting("eval", make_eval(*args, **kwargs))

    trainer_module.make_train_step, trainer_module.make_eval_step = make_train_step, make_eval_step

    def restore():
        trainer_module.make_train_step, trainer_module.make_eval_step = make_train, make_eval

    return runs, restore


def run_totals(run):
    return {k: sum(c[k] for c in run["train"] + run["eval"]) for k in expected_launches()}


def trace_kernels(trace_dir: Path):
    """(kernel names, device-busy share) of the Chrome trace under
    ``trace_dir``: the kernels' summed durations over the trace's span."""
    (path,) = trace_dir.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return sorted({e["name"] for e in kernels}), sum(e["dur"] for e in kernels) / span


def step_records(run_dir: Path):
    return [r for r in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
            if "train/loss" in r and "epoch" not in r]


def counted_loader_epochs():
    """(seeds, restore): every epoch that the native batch loader serves
    until ``restore()`` appends its seed to ``seeds``."""
    from rlvae_tpu_torch.data.native_loader import NativeBatchLoader

    seeds, epoch = [], NativeBatchLoader.epoch

    def counted(self, seed=0, shuffle=True):
        seeds.append(seed)
        yield from epoch(self, seed, shuffle)

    NativeBatchLoader.epoch = counted

    def restore():
        NativeBatchLoader.epoch = epoch

    return seeds, restore


def native_loader_check():
    """A data module as the single run's (synthetic sprites, EXP_TRAIN
    sequences, batch 4, seed 42): each of two epochs' batches through the
    native loader are a permutation of the training rows, the same when
    the epoch is asked for twice, and the two epochs' orders differ."""
    from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
    from rlvae_tpu_torch.data import native_loader

    t0 = time.perf_counter()
    dm = CyclicDataModule({**CYCLIC_SPRITES, "synthetic_n_test": EXP_TEST}, seed=42)
    dm.setup({"data": {"batch_size": 4}, "n_train_samples": EXP_TRAIN,
              "n_val_samples": EXP_VAL})
    row_of = {r.tobytes(): i for i, r in enumerate(dm.train.data)}
    check(len(row_of) == len(dm.train.data), "repeated training rows")
    orders = []
    for epoch in (0, 1):
        batches = list(dm.train_batches(epoch))
        again = list(dm.train_batches(epoch))
        check(len(batches) == len(again) == EXP_TRAIN // 4
              and all(np.array_equal(a, c) for a, c in zip(batches, again)),
              f"epoch {epoch}: the native loader's batches differ for one seed")
        order = [row_of.get(r.tobytes(), -1) for batch in batches for r in batch]
        check(sorted(order) == list(range(EXP_TRAIN)),
              f"epoch {epoch}: the batches are not a permutation of the rows: {order}")
        orders.append(order)
    check(orders[0] != orders[1], "two epochs in one order")
    check(dm._native_loader is not None, "the data module batched without the native loader")
    return {"library": native_loader.library_path().name, "host_s": time.perf_counter() - t0,
            "batches_per_epoch": EXP_TRAIN // 4, "epoch_orders": orders}


def run_experiment(torch, dev=None):
    """``rlvae_tpu_torch.experiment.main`` as a user runs it, in temporary
    run directories: a single run of the default model with the epoch-0
    profile, ``from_run`` on its directory against the CPU, the comparison
    study, a two-job ``-m`` multirun of ``hybrid_rlvae`` over
    ``sampling.method=enhanced,geodesic``, and one run of the fast preset.
    ``dev`` (the CPU, for a rehearsal) adds ``training.trainer.accelerator=cpu``."""
    from rlvae_tpu_torch import ModelManager, experiment
    from rlvae_tpu_torch.config import load_yaml

    device = [] if dev is None else [f"training.trainer.accelerator={dev.type}"]
    b123 = expected_launches(chol_bundle=2, iaf_chain_fwd=1, iaf_chain_bwd=1)
    out, runs_by_name = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_experiment_") as tmp:
        tmp = Path(tmp)
        runs, restore = counted_trainers()
        loader_seeds, restore_loader = counted_loader_epochs()
        try:
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            single = tmp / "single"
            (result,) = experiment.main(["model=riemannian_flow_vae", "training=quick",
                                         "training.trainer.max_epochs=2",
                                         "training.trainer.profile=true", *EXP_CUT, *device,
                                         f"run.dir={single}"])
            out["single_s"] = time.perf_counter() - t0
            runs_by_name["single"] = runs[-1]

            t = time.perf_counter()
            experiment.main(["experiment=comparison_study", *EXP_CUT, *device,
                             "experiment.training_override.n_epochs=1",
                             f"experiment.training_override.n_train_samples={EXP_TRAIN // 2}",
                             f"experiment.training_override.n_val_samples={EXP_VAL}",
                             f"run.dir={tmp / 'comparison'}"])
            out["comparison_s"] = time.perf_counter() - t
            runs_by_name["vanilla_vae"], runs_by_name["riemannian_flow_vae"] = runs[-2:]

            t = time.perf_counter()
            experiment.main(["-m", "model=hybrid_rlvae", "model.sampling.method=enhanced,geodesic",
                             "training=quick", "training.trainer.max_epochs=1", *EXP_CUT, *device,
                             f"sweep.dir={tmp / 'sweep'}"])
            out["multirun_s"] = time.perf_counter() - t
            runs_by_name["hybrid_enhanced"], runs_by_name["hybrid_geodesic"] = runs[-2:]

            t = time.perf_counter()
            experiment.main(["model=riemannian_flow_vae_fast", "training=quick",
                             "training.trainer.max_epochs=1", *EXP_CUT, *device,
                             f"run.dir={tmp / 'fast'}"])
            out["fast_s"] = time.perf_counter() - t
            runs_by_name["fast"] = runs[-1]
        finally:
            restore()
            restore_loader()
        torch.cuda.synchronize()
        out["runs_s"] = time.perf_counter() - t0
        launches = launch_counts()
        check(len(runs) == 6, f"{len(runs)} trainers in the experiment phase")
        # single 2, comparison 1 + 1, multirun 1 + 1, fast 1
        check(len(loader_seeds) == 7, f"the native loader served {len(loader_seeds)} epochs")
        out["native_loader"] = {**native_loader_check(), "epochs_served": len(loader_seeds)}

        # the single run: files, launches, step records, the profile
        for f in ("config.yaml", "results.yaml", "metrics.jsonl", "checkpoints/best/state.pt",
                  "checkpoints/last/state.pt", "checkpoints/model_config.json"):
            check((single / f).exists(), f"the single run wrote no {f}")
        res = load_yaml((single / "results.yaml").read_text())
        check(res["epochs_run"] == 2 and all(np.isfinite(v) for v in res["test"].values()),
              f"single run results {res}")
        run = runs_by_name["single"]
        n_steps = 2 * EXP_TRAIN // 4
        check(len(run["train"]) == n_steps and all(c == b123 for c in run["train"]),
              f"single run steps launched {run['train']}")
        b137 = expected_launches(chol_bundle=3, iaf_chain_fwd=1, g_inv=1)
        check(run["eval"] and all(c == b137 for c in run["eval"]),
              f"single run evaluation batches launched {run['eval']}")
        records = step_records(single)
        check(len(records) == n_steps and all(set(TIMER_KEYS) <= set(r) for r in records),
              "step records without StepTimer keys")
        names, busy = trace_kernels(single / "profile")
        for want in B2_B3_NAMES:
            check(any(want in n for n in names), f"the epoch-0 profile names no {want}: {names}")
        viz_errors = [r["viz/error"] for r in map(json.loads, (single / "metrics.jsonl")
                                                  .read_text().splitlines()) if "viz/error" in r]
        if matplotlib_imports():
            check(not viz_errors, f"viz/error records with matplotlib: {viz_errors}")
        else:  # each due module fails at its matplotlib import: 4 at epoch 0, 1 at 1
            check(len(viz_errors) == 5 and all("matplotlib" in e for e in viz_errors),
                  f"viz/error records without matplotlib: {viz_errors}")
        out["single"] = {"result": {k: result[k] for k in ("best_val_loss", "epochs_run", "steps",
                                                           "train_time")},
                         "test": res["test"], "launches": run_totals(run),
                         "viz_errors": len(viz_errors),
                         "launches_per_step": run["train"][0],
                         "launches_per_eval_batch": run["eval"][0],
                         "step_time": {k: records[-1][k] for k in TIMER_KEYS},
                         "profile": {"kernel_names": len(names), "device_busy_share": busy,
                                     "iaf": [n for n in names if "iaf_chain" in n]}}

        # the trained run served from its directory, card against the CPU
        rng = np.random.default_rng(17)
        seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
        eps = torch.tensor(rng.normal(size=(SERVE_BATCH, 16)), dtype=torch.float32)
        card = ModelManager.from_run(single, device=dev)
        check(dev is not None or card.device.type == "cuda", f"from_run on {card.device}")
        cpu = ModelManager.from_run(single, device="cpu")
        out["from_run_cuda_vs_cpu"] = compare_trained_forward(torch, card, cpu, seqs, eps)[0]

        cmp = load_yaml((tmp / "comparison" / "results.yaml").read_text())
        check(sorted(cmp["models"]) == ["riemannian_flow_vae", "vanilla_vae"]
              and sorted(cmp["comparison"]) == sorted(cmp["models"]),
              f"comparison results {sorted(cmp)}")
        for name, r in cmp["models"].items():
            finite = [r["best_val_loss"], *r["test"].values()]
            check(all(np.isfinite(v) for v in finite), f"comparison {name} not finite")
        check(all(c == b123 for c in runs_by_name["riemannian_flow_vae"]["train"]),
              "comparison riemannian_flow_vae steps")
        check(sum(run_totals(runs_by_name["vanilla_vae"]).values()) == 0,
              "the vanilla VAE launched a kernel")
        out["comparison"] = {name: {"best_val_loss": r["best_val_loss"],
                                    "launches": run_totals(runs_by_name[name])}
                             for name, r in cmp["models"].items()}

        methods = [load_yaml((tmp / "sweep" / str(i) / "config.yaml").read_text())["model"]
                   ["sampling"]["method"] for i in (0, 1)]
        check(methods == ["enhanced", "geodesic"], f"multirun jobs {methods}")
        enhanced, geodesic = runs_by_name["hybrid_enhanced"], runs_by_name["hybrid_geodesic"]
        check(all(c["metric_bundle"] == 0 for c in enhanced["train"] + enhanced["eval"]),
              "the enhanced job launched the metric bundle")
        check(all(c["metric_bundle"] == 1 for c in geodesic["train"] + geodesic["eval"])
              and geodesic["train"] and geodesic["eval"],
              f"geodesic job: {geodesic['train'][:1]} {geodesic['eval'][:1]}")
        out["multirun"] = {m: {"launches": run_totals(r), "launches_per_step": r["train"][0],
                               "launches_per_eval_batch": r["eval"][0],
                               "step_time": {k: step_records(tmp / "sweep" / str(i))[-1][k]
                                             for k in TIMER_KEYS}}
                           for i, (m, r) in enumerate(zip(methods, (enhanced, geodesic)))}

        fast = runs_by_name["fast"]
        b5 = expected_launches(chol_bundle=2, decode_mse_fwd=1, decode_mse_bwd_dh=1,
                               decode_mse_bwd_dw=1)
        check(fast["train"] and all(c == b5 for c in fast["train"]),
              f"fast run steps launched {fast['train'][:1]}")
        out["fast"] = {"launches": run_totals(fast), "launches_per_step": fast["train"][0],
                       "step_time": {k: step_records(tmp / "fast")[-1][k] for k in TIMER_KEYS}}
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# convnets phase
# ---------------------------------------------------------------------------

CONF = Path(__file__).resolve().parent / "conf"
CONVNET_MODELS = ("cnn_rlvae", "resnet_rlvae", "mlp_rlvae")
CONVNET_STEPS = 2  # 3 until the viz phase joined the run (its time budget)
CONVNET_CUT = {}  # extra overrides by model (a CPU rehearsal narrows the nets here)
CONVNET_IMAGE = 64
# the card-vs-CPU forward's batch: every row is independent in eval (BatchNorm
# reads its running statistics), and the CPU runs the full-width nets
CONVNET_CMP_BATCH = 16
# the fp32-policy run: fp32 nets at the near-identity flow init, where the
# latent stays O(10) and every step's gradients are reproducible
CONVNET_FP32 = ("model.encoder.dtype=float32", "model.decoder.dtype=float32",
                "+model.flow_log_var_bias_init=0.0")
# Card step vs the same step replayed on the CPU from the card's state, batch,
# noise and dropout masks.  The shipped configs train at the reference flow
# init, where each transition scales the latent ~20x: at step 1 |z| reaches
# ~4e8 (measured), and there the flows' weight gradients are not
# reproducible across devices even in fp32 (a summation order moves them by
# up to 0.7 of their scale; the grad norm, which they dominate, by 47x in
# bf16), as tests/test_torch_train.py finds for JAX's own steps.  So the
# bf16 runs gate what the step computes before its backward: every loss
# term, and the BatchNorm statistics it leaves; grad_norm and the nets'
# gradients are reported.  Those losses are dominated by frames decoded
# from latents up to ~1e8, which carry bf16's 2^-8 relative rounding, and
# the decoder's statistics are of such activations: the largest errors read
# in three calls were 2.5e-3 (cnn recon_loss, step 3), flow_loss 6.7e-3,
# the statistics 1.0e-2 (cnn, step 1).  Steps 2 and 3 start from states
# that cuDNN's non-deterministic weight gradients make differ per call, so
# the tolerances keep 5x or more.  The fp32 run, at the near-identity flow
# init, holds losses, statistics and grad_norm to 1e-4 (measured 4.9e-5 at
# most, grad_norm), and gates the encoder's and decoder's step-1 gradients
# (global relative L2 of each net) at 1e-3: cuDNN picks its own fp32
# algorithms, whose sums differ from the CPU's, and a BatchNorm's backward
# subtracts two batch means from every cotangent (the decoder's 1.2e-4).
CONVNET_REPLAY_TOL = {
    "bfloat16": {"loss_rel": 2e-2, "flow_loss_rel": 5e-2, "stats_rel": 5e-2},
    "float32": {"loss_rel": 1e-4, "flow_loss_rel": 1e-4, "stats_rel": 1e-4,
                "grad_norm_rel": 1e-4, "net_grad_rel": 1e-3},
}
# Card vs CPU forward of the served nets (E2E_TOL holds the MLP phases).
# The frames t >= 1 decode latents that the reference-init flows scale ~20x
# per transition (|z| up to 4e8 measured), where the conv decoders, which
# have no output activation, round apart on the two devices: the resnet's
# mean |d recon| over all frames read 2.5e-3 and 2.8e-2 in two calls.  So
# the reconstruction is gated on frame 0, decoded from z0 (measured at most
# 1.3e-5, the resnet's), and reported over all frames; z relative to its
# scale measured 4.6e-4 to 9.9e-4 over three calls.
CONVNET_E2E_TOL = {k: v for k, v in E2E_TOL.items() if k != "recon_mean_abs"}
CONVNET_E2E_TOL["z_rel"] = 5e-3
CONVNET_RECON0_TOL = 1e-3  # mean |d recon| of frame 0
PORTED_KERNEL_NAMES = ("chol_bundle_kernel", "iaf_chain_fwd_kernel", "iaf_chain_bwd_kernel",
                       "hmc_terms_kernel", "metric_bundle_kernel", "hmc_partials_kernel",
                       "g_inv", "fwd_kernel", "dh_kernel", "dw_kernel", "sum_kernel")


def net_buffers(model):
    """The nets' BatchNorm running statistics, copied."""
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.startswith(("encoder.", "decoder."))}


def conv_config(name, *overrides):
    """A model config composed from ``conf/`` at its published widths, cut
    only in what ``CONVNET_CUT`` and the overrides say."""
    from rlvae_tpu_torch.config import compose

    return compose(CONF, "config", [f"model={name}", *CONVNET_CUT.get(name, ()), *overrides])


def device_split(kernels):
    """Profiled device us by kind of kernel: the ported kernels (csrc/),
    cuDNN convolutions, reductions (BatchNorm's statistics, the norms and
    the loss sums), elementwise kernels (BatchNorm's normalisation, casts,
    activations, dropout), cuBLAS/CUTLASS products, and the rest (Adam's
    fused kernels, copies).  Ranges that are user annotations
    (``Optimizer.step#...``) span other kernels and are left out."""
    split = {"ported_us": 0.0, "conv_us": 0.0, "reduce_us": 0.0, "elementwise_us": 0.0,
             "gemm_us": 0.0, "other_us": 0.0}
    for k in kernels:
        name = k["name"].lower()
        if "#" in name:
            continue
        if any(n in name for n in PORTED_KERNEL_NAMES):
            kind = "ported_us"
        elif any(n in name for n in ("conv", "cudnn", "dgrad", "wgrad", "fprop", "implicit",
                                     "winograd", "nchw", "nhwc")):
            kind = "conv_us"
        elif "reduce" in name:
            kind = "reduce_us"
        elif "elementwise" in name:
            kind = "elementwise_us"
        elif any(n in name for n in ("gemm", "cutlass", "cublas")):
            kind = "gemm_us"
        else:
            kind = "other_us"
        split[kind] += k["us"]
    split["busy_us"] = sum(split.values())
    return split


def conv_train_and_replay(torch, name, cfg, run_dir, dev, dtype="bfloat16"):
    """CONVNET_STEPS Trainer steps of ``cfg``'s model at B=16 with one
    validation batch, each step's launches gated and the step replayed on
    the CPU from the card's state with the same batch, noise and dropout
    masks; then one warm step timed and profiled."""
    import warnings

    from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
    from rlvae_tpu_torch.models import create_model
    from rlvae_tpu_torch.nets import DropoutMasks
    from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer, make_optimizer, make_train_step

    model_cfg = cfg["model"]
    tcfg = copy.deepcopy(TRAINING_PRESETS["default"])
    tcfg["data"]["batch_size"] = TRAIN_BATCH
    tcfg["n_train_samples"], tcfg["n_val_samples"] = CONVNET_STEPS * TRAIN_BATCH, TRAIN_BATCH
    data = CyclicDataModule({**CYCLIC_SPRITES, "image_size": [CONVNET_IMAGE] * 2,
                             "synthetic_n_test": TRAIN_BATCH}, seed=0)
    data.setup(tcfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = create_model(model_cfg, seed=0)
    loaded = not any("pretrained components not loaded" in str(w.message) for w in caught)
    trainer = Trainer(model, data, tcfg, run_dir=run_dir, seed=0, device=dev)
    check(dev is not None or trainer.device.type == "cuda", f"trainer on {trainer.device}")
    before = net_buffers(model)

    records, step = [], trainer.train_step

    def recorded_step(x, noise):
        rec = {"state": {k: v.detach().clone() for k, v in model.state_dict().items()},
               "opt": copy.deepcopy(trainer.optimizer.state_dict()), "x": x.cpu(),
               "noise": {k: v.cpu() for k, v in noise.items()}}
        masks = DropoutMasks(trainer.generator, record=True)
        counts = launch_counts()
        t = time.perf_counter()
        metrics = step(x, noise, masks)
        torch.cuda.synchronize()
        rec["host_ms"] = (time.perf_counter() - t) * 1e3
        rec["launches"] = {k: v - counts[k] for k, v in launch_counts().items()}
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        rec["masks"] = [m.cpu() for m in masks.drawn]
        if not records:
            rec["grads"] = {n: q.grad.detach().cpu().clone() for n, q in model.named_parameters()}
        records.append(rec)
        return metrics

    trainer.train_step = recorded_step
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    result = trainer.fit(max_steps=CONVNET_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    trainer.train_step = step
    per_step = expected_launches(chol_bundle=2, iaf_chain_fwd=1, iaf_chain_bwd=1)
    check(result["steps"] == CONVNET_STEPS == len(records), f"{name}: ran {result['steps']} steps")
    for i, rec in enumerate(records):
        check(rec["launches"] == per_step, f"{name} step {i + 1} launched {rec['launches']}")
        check(all(np.isfinite(v) for v in rec["metrics"].values()), f"{name} step {i + 1} not finite")
        check(len(rec["masks"]) > 0, f"{name} step {i + 1} drew no dropout mask")
    check(launches["g_inv"] == 1,  # n_val_samples = TRAIN_BATCH: one validation batch
          f"{name}: {launches['g_inv']} G^-1 launches in one validation batch")
    validation = result["history"][-1]
    check(all(np.isfinite(v) for v in validation.values()), f"{name}: non-finite validation")
    after = net_buffers(model)
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    check(len(moved) == len(before), f"{name}: running stats that did not move: "
          f"{sorted(set(before) - set(moved))[:4]}")

    # the same steps on the CPU, each from the card's state, noise and masks
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cpu_model = create_model(model_cfg, seed=0)
    opt_cfg = tcfg["optimizer"]
    cpu_opt = make_optimizer(cpu_model.parameters(), opt_cfg["lr"], opt_cfg["weight_decay"])
    cpu_step = make_train_step(cpu_model, cpu_opt)
    tol = CONVNET_REPLAY_TOL[dtype]
    errors = []
    for i, rec in enumerate(records):
        cpu_model.load_state_dict(rec["state"])
        cpu_opt.load_state_dict(rec["opt"])
        m = {k: float(v) for k, v in
             cpu_step(rec["x"], rec["noise"], DropoutMasks(replay=rec["masks"])).items()}
        err = {k: abs(rec["metrics"][k] - m[k]) / max(abs(m[k]), 1e-12)
               for k in ("loss", "recon_loss", "kld_loss", "flow_loss", "grad_norm")}
        if i == 0:
            for net in ("encoder", "decoder", "flows"):
                names = [n for n, _ in cpu_model.named_parameters() if n.startswith(net + ".")]
                want = torch.cat([cpu_model.get_parameter(n).grad.flatten() for n in names])
                got = torch.cat([rec["grads"][n].flatten() for n in names])
                err[f"{net}_grad_rel"] = float((got - want).norm() / want.norm().clamp_min(1e-30))
            if "net_grad_rel" in tol:
                for net in ("encoder", "decoder"):
                    check(err[f"{net}_grad_rel"] <= tol["net_grad_rel"],
                          f"{name} step 1 {net} gradients: card vs CPU {err[f'{net}_grad_rel']}")
        if i + 1 < len(records):
            cpu_stats = net_buffers(cpu_model)
            err["stats_rel"] = max(
                [float((records[i + 1]["state"][k].cpu() - v).abs().max()
                       / v.abs().max().clamp_min(1e-12)) for k, v in cpu_stats.items()],
                default=0.0)
            check(err["stats_rel"] <= tol["stats_rel"],
                  f"{name} step {i + 1} BatchNorm stats: card vs CPU {err['stats_rel']}")
        errors.append(err)
        for k in ("loss", "recon_loss", "kld_loss", "flow_loss"):
            t = tol["flow_loss_rel" if k == "flow_loss" else "loss_rel"]
            check(err[k] <= t, f"{name} step {i + 1} {k}: card vs CPU {err[k]}")
        if "grad_norm_rel" in tol:
            check(err["grad_norm"] <= tol["grad_norm_rel"],
                  f"{name} step {i + 1} grad_norm: card vs CPU {err['grad_norm']}")
    replay_s = time.perf_counter() - t0

    # one warm step: host ms (synchronised), device ms (CUDA events), profile
    x = records[-1]["x"].to(trainer.device)
    noise = {k: v.to(trainer.device) for k, v in records[-1]["noise"].items()}
    gen = torch.Generator(device=trainer.device).manual_seed(1)
    warm = lambda: step(x, noise, DropoutMasks(gen))  # noqa: E731
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        warm()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    step_ms = time_ms(torch, warm, 3)
    _, kernels = device_time_by_kernel(torch, warm)
    split = device_split(kernels)
    busy_ms = split["busy_us"] / 1e3
    return {
        "dtype": dtype, "pretrained_loaded": loaded, "steps": result["steps"],
        "batch": TRAIN_BATCH, "fit_s": fit_s, "replay_s": replay_s,
        "launches": launches, "launches_per_step": records[0]["launches"],
        "losses": [r["metrics"]["loss"] for r in records],
        "step_host_ms": [r["host_ms"] for r in records],
        "dropout_masks_per_step": len(records[0]["masks"]),
        "batchnorm_buffers": len(before),
        "validation": {k: v for k, v in validation.items() if k.startswith("val/")},
        "card_vs_cpu": {"errors": errors, "tolerances": tol},
        "warm_step": {"host_ms_median": float(np.median(host)), "device_events_ms": step_ms,
                      "profiled_device_busy_ms": busy_ms,
                      "device_busy_share": busy_ms / float(np.median(host)),
                      "device_split_us": split, "top_kernels": kernels[:8]},
    }


def conv_serve(torch, name, run_dir, dev):
    """``ModelManager.from_run`` on the run's ``best`` slot behind a
    ``BatchingEngine``: 64 requests of each op (``reconstruct``, ``encode``,
    ``decode``, and ``generate`` seeds through the official chain), each op
    in one bucket with its launches gated; a forward on the card against the
    CPU."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, ServeConfig
    from rlvae_tpu_torch.train import CheckpointManager

    t0 = time.perf_counter()
    manager = ModelManager.from_run(run_dir, device=dev)
    load_s = time.perf_counter() - t0
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    best = CheckpointManager(Path(run_dir) / "checkpoints").restore("best",
                                                                    map_location=manager.device)
    state = manager.model.state_dict()
    check(all(torch.equal(state[k], v) for k, v in best["params"].items()),
          f"{name}: from_run did not restore the best slot bit for bit")
    rng = np.random.default_rng(8)
    size = (3, CONVNET_IMAGE, CONVNET_IMAGE)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, *size)).astype(np.float32)
    latents = rng.normal(size=(SERVE_BATCH, 16)).astype(np.float32)
    engine = BatchingEngine.from_manager(
        manager, ServeConfig(buckets=(SERVE_BATCH,), max_wait_ms=2000),
        generate_method="official")
    out = {}
    try:
        engine.warmup({"reconstruct": seqs[0], "encode": seqs[0, 0], "decode": latents[0]})
        for op, items, want in (
                ("reconstruct", list(seqs), expected_launches(chol_bundle=2, iaf_chain_fwd=1)),
                ("encode", list(seqs[:, 0]), expected_launches()),
                ("decode", list(latents), expected_launches()),
                ("generate", [np.uint32(s) for s in range(SERVE_BATCH)],
                 expected_launches(iaf_chain_fwd=1, **GEN_LAUNCHES["official"]))):
            torch.cuda.synchronize()
            zero_launch_counts()
            batches = engine.stats_snapshot()["batches"]
            t = time.perf_counter()
            rows = [f.result(timeout=120) for f in [engine.submit(op, i) for i in items]]
            ms = (time.perf_counter() - t) * 1e3
            counts = launch_counts()
            check(engine.stats_snapshot()["batches"] - batches == 1,
                  f"{name}: the {len(items)} {op} requests took more than one batch")
            check(counts == want, f"{name}: one {op} batch launched {counts}")
            check(all(np.isfinite(r).all() for r in rows), f"{name}: non-finite {op} rows")
            out[op] = {"requests": len(items), "host_ms": ms, "launches": counts,
                       "row_shape": list(np.shape(rows[0]))}
    finally:
        engine.stop()
    check(out["reconstruct"]["row_shape"] == [8, *size] and out["generate"]["row_shape"]
          == [8, *size], f"{name}: bad row shapes {out}")

    x = seqs[:CONVNET_CMP_BATCH]
    eps = torch.tensor(rng.normal(size=(CONVNET_CMP_BATCH, 16)), dtype=torch.float32)
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    compare, out_gpu, out_cpu = compare_trained_forward(torch, manager, cpu, x, eps,
                                                        CONVNET_E2E_TOL)
    compare["recon_mean_abs_value"] = float(out_cpu["recon_x"].abs().mean())
    compare["z_max_abs"] = float(out_cpu["z"].abs().max())
    compare["recon_mean_abs_by_frame"] = [
        float((out_gpu["recon_x"][:, t].float().cpu() - out_cpu["recon_x"][:, t]).abs().mean())
        for t in range(x.shape[1])]
    compare["recon0_tolerance"] = CONVNET_RECON0_TOL
    check(compare["recon_mean_abs_by_frame"][0] <= CONVNET_RECON0_TOL,
          f"{name}: card vs CPU frame-0 reconstruction {compare['recon_mean_abs_by_frame'][0]}")
    launches = {k: sum(o["launches"][k] for o in out.values()) for k in expected_launches()}
    return {"load_s": load_s, "ops": out, "cuda_vs_cpu": compare, "launches": launches}


def run_convnets(torch, dev=None):
    """The convolutional families and dropout: for each of ``cnn_rlvae``,
    ``resnet_rlvae`` and ``mlp_rlvae`` composed from ``conf/`` at their
    published widths (64x64 frames, 8 flows), CONVNET_STEPS Trainer steps
    replayed on the CPU, then the run served from ``from_run``; and one
    fp32-policy ``cnn_rlvae`` run at the near-identity flow init, replayed
    at 1e-4."""
    from rlvae_tpu_torch.config import save_config

    out, totals = {}, expected_launches()
    for name in CONVNET_MODELS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as run_dir:
            cfg = conv_config(name)
            train = conv_train_and_replay(torch, name, cfg, run_dir, dev)
            save_config(cfg, Path(run_dir) / "config.yaml")
            serve = conv_serve(torch, name, run_dir, dev)
        out[name] = {"train": train, "serve": serve, "seconds": time.perf_counter() - t0}
        for k in totals:
            totals[k] += train["launches"][k] + serve["launches"][k]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cnn_fp32_") as run_dir:
        train = conv_train_and_replay(torch, "cnn_rlvae", conv_config("cnn_rlvae", *CONVNET_FP32),
                                      run_dir, dev, dtype="float32")
    out["cnn_rlvae_fp32"] = {"train": train, "seconds": time.perf_counter() - t0}
    for k in totals:
        totals[k] += train["launches"][k]
    out["launches"] = totals
    return out


# ---------------------------------------------------------------------------
# geometry phase
# ---------------------------------------------------------------------------

GEO_PAIRS = 64            # centroid-to-centroid pairs of exp_map, log_map, shooting
GEO_SHOOT = {"n_steps": 8, "n_iters": 6}  # log_map's RK4 steps and Gauss-Newton iterations
GEO_SHOOT_POINTS = 9      # points of the shooting interpolation (k = 1 replay step)
GEO_LOG_REPLAY_ROWS = 1   # rows of log_map and the shooting path replayed on the CPU
GEO_EXACT_SEED, GEO_EXACT_ITERS = 5, 80
GEO_CURV_GRID = 32        # the curvature's grid on the centroids' PCA plane
GEO_INTERP_ITERS = 200    # interpolate(mode="geodesic"): energy_path's Adam steps
GEO_ENERGY_BAND = 20      # the CPU path's last iterates whose energies bound the card's
GEO_PROFILE_ITERS = 20    # Adam steps of the profiled energy path
RHVAE_BATCH, RHVAE_STEPS = 64, 2  # 3 steps until the latent_dims phase joined the run
# Card vs CPU.  The geodesic solvers feed every rounding difference back
# (Adam's m / sqrt(v) turns last-bit gradient differences into lr-sized
# steps; shooting follows a curved ODE), so whole results are held at these
# tolerances, each relative to max(1, |value|) unless said otherwise.
GEO_TOL = {
    "christoffel_rel": 1e-4,      # of the largest |Gamma|, one launch vs plain
    "exp_map": 1e-4,              # endpoint and path of 32 RK4 steps
    "log_map": 1e-3,              # the shooting velocity (fixed point of Gauss-Newton)
    "shooting": 1e-3,             # the shooting path
    "energy_path": 1e-2,          # points of the interpolation's energy path, which lies
                                  # where the metric barely curves (tests: JAX vs port up
                                  # to 4.2e-3 with the inputs' last bits)
    "energy_rtol": 2e-3,          # its energy (tests: up to 8.7e-4), or within the band of
                                  # the CPU's last GEO_ENERGY_BAND iterates (Adam at lr 0.05
                                  # does not settle: its iterates circle the optimum)
    "geodesic_exact": 2e-3,       # prior latents, pairs of distinct centroids
    "curvature": 1e-3,            # of the largest |K| on the grid
    "frames": 1e-3,               # decoded frames, pixels in [0, 1]
}


def counted(torch, fn):
    """(``fn()``, the launches it made): counters zeroed just before, read
    just after a synchronisation."""
    torch.cuda.synchronize()
    zero_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _scaled(got, want, floor=1.0) -> float:
    """max |got - want| over max(floor, max |want|), on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(floor, float(want.abs().max()))


def pca_plane(c: np.ndarray, n: int):
    """(basis [D, 2], origin [D], grid [n*n, 2]): the centroids' first two
    principal directions, their mean, and an n x n grid over the range of
    the centroids' coordinates in that plane."""
    origin = c.mean(0)
    _, _, vt = np.linalg.svd(c - origin, full_matrices=False)
    basis = vt[:2].T.astype(np.float32)
    coords = (c - origin) @ basis
    axes = [np.linspace(coords[:, i].min(), coords[:, i].max(), n) for i in range(2)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    return basis, origin.astype(np.float32), grid


def energy_path_trace(torch, metric, z0, z1, n_points, n_iters, lr=0.05):
    """``energy_path`` of one pair stepped here with its own ``energy_grad``
    and ``adam_update`` (the path held equal to ``energy_path``'s bit for
    bit), with each iterate's energy: (path [n_points, D], energies)."""
    from rlvae_tpu_torch.geometry import geodesics as tgeo

    a, b = z0[None].float(), z1[None].float()
    ts = tgeo._linspace01(n_points, a.device)[1:-1, None]
    x = (1.0 - ts) * a[:, None] + ts * b[:, None]
    mu, nu, energies = torch.zeros_like(x), torch.zeros_like(x), []
    with torch.no_grad():
        for count in range(1, n_iters + 1):
            x, mu, nu = tgeo.adam_update(x, tgeo.energy_grad(metric, a, b, x), mu, nu, count, lr)
            energies.append(float(tgeo._segment_energy(
                metric, torch.cat([a[:, None], x, b[:, None]], dim=1))[0]))
        path = torch.cat([a[:, None], x, b[:, None]], dim=1)[0]
        check(torch.equal(path, tgeo.energy_path(metric, z0, z1, n_points=n_points,
                                                 n_iters=n_iters, lr=lr)),
              "the stepped energy path differs from energy_path")
    return path, energies


def exact_prior_replay(torch, metric, cpu_metric, z, noise):
    """The ``geodesic_exact`` prior latents z (on the card) replayed on the CPU
    from the same draws.  Rows whose pair is one centroid have a zero-length
    path, whose tangent (the noise's direction) is rounding noise on either
    device: they are held to lie within the noise's reach of the centroid."""
    from rlvae_tpu_torch.samplers import sample_prior

    noise_cpu = {k: v.cpu() for k, v in noise.items()}
    with torch.no_grad():
        z_cpu = sample_prior(cpu_metric, z.shape[0], 16, "geodesic_exact", noise=noise_cpu)
    same = (noise_cpu["i1"] == noise_cpu["i2"])
    err = _scaled(z.cpu()[~same], z_cpu[~same]) if bool((~same).any()) else 0.0
    check(err <= GEO_TOL["geodesic_exact"], f"geodesic_exact: card vs CPU {err}")
    reach_ok = True
    for i in torch.nonzero(same).flatten().tolist():
        c = cpu_metric.centroids[noise_cpu["i1"][i]]
        eig = float(torch.linalg.eigvalsh(cpu_metric.g_inv(c[None]))[0].max())
        reach = 0.2 * float(noise_cpu["eps"][i].norm()) * eig ** 0.5 + 0.1
        reach_ok = reach_ok and float((z.cpu()[i] - c).abs().max()) <= reach
        reach_ok = reach_ok and float((z_cpu[i] - c).abs().max()) <= reach
    check(reach_ok, "a zero-length geodesic_exact row left its centroid's noise reach")
    return {"max_err": err, "zero_length_rows": int(same.sum())}


def run_geometry(torch, dev=None):
    """The latent geometry and RHVAE metric pre-training (section 15 of the
    module docstring)."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
    from rlvae_tpu_torch.convert import load_pretrained_net
    from rlvae_tpu_torch.data import generate_cyclic_sequences
    from rlvae_tpu_torch.geometry import curvature as tcurv
    from rlvae_tpu_torch.geometry import geodesics as tgeo
    from rlvae_tpu_torch.geometry import load_metric, save_metric
    from rlvae_tpu_torch.geometry.pretrain import RHVAE, train_metric
    from rlvae_tpu_torch.nets import create_decoder, create_encoder
    from rlvae_tpu_torch.ops.metric_kernels import (
        chol_bundle,
        chol_bundle_ref,
        g_inv,
        g_inv_ref,
        hmc_terms,
        hmc_terms_ref,
        metric_bundle,
        metric_bundle_ref,
    )
    from rlvae_tpu_torch.samplers import concat_rows

    t_phase, laps, total = time.perf_counter(), {}, {}
    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    dev, model, metric = manager.device, manager.model, manager.model.metric
    cpu_metric = metric.to("cpu")
    c = cpu_metric.centroids
    out = {"metric": f"K={metric.n_centroids}, T={metric.temperature}"}

    # 1. interpolate(mode="geodesic"): 200 Adam steps, one metric bundle each
    rng = np.random.default_rng(11)
    x1 = rng.uniform(size=(3, 64, 64)).astype(np.float32)
    x2 = rng.uniform(size=(3, 64, 64)).astype(np.float32)
    t = time.perf_counter()
    frames, counts = counted(torch, lambda: manager.interpolate(x1, x2, n_steps=10,
                                                                mode="geodesic"))
    interp_s = time.perf_counter() - t
    check(counts == expected_launches(metric_bundle=GEO_INTERP_ITERS),
          f"interpolate(geodesic) launched {counts}")
    check(counts["metric_bundle"] >= 200, "fewer than 200 metric-bundle launches")
    add_counts(total, counts)
    check(frames.shape == (10, 3, 64, 64) and np.isfinite(frames).all(), "bad geodesic frames")
    mu1, mu2 = (manager._tensor(manager.encode(x[None]).embedding[0]) for x in (x1, x2))
    path, energies_card = energy_path_trace(torch, metric, mu1, mu2, 10, GEO_INTERP_ITERS)
    energy = energies_card[-1]
    path_cpu, energies = energy_path_trace(torch, cpu_metric, mu1.cpu(), mu2.cpu(), 10,
                                           GEO_INTERP_ITERS)
    again = manager.decode(path)
    band = max(abs(e - energies[-1]) for e in energies[-GEO_ENERGY_BAND:])
    interp = {"host_s": interp_s, "launches": counts,
              "path_err": _scaled(path, path_cpu),
              "energy": energy, "energy_cpu": energies[-1],
              "energy_rel": abs(energy - energies[-1]) / abs(energies[-1]),
              "energy_band_rel": band / abs(energies[-1]),
              "energy_at": {str(i): [energies_card[i - 1], energies[i - 1]]
                            for i in (1, 2, 3, 5, 10, 50, 100, 150, 200)},
              "frames_vs_decoded_path": float(np.abs(again - frames).max())}
    check(interp["path_err"] <= GEO_TOL["energy_path"], f"geodesic path: card vs CPU {interp}")
    check(interp["energy_rel"] <= max(GEO_TOL["energy_rtol"], interp["energy_band_rel"]),
          f"geodesic energy: card vs CPU {interp}")
    check(interp["frames_vs_decoded_path"] <= GEO_TOL["frames"], f"geodesic frames {interp}")
    # GEO_PROFILE_ITERS Adam steps of the same path, warm: host ms per step
    # unprofiled, then device time per step from a profiled run (the
    # profiler's own cost grows with the launches, ~60 a step), busy share
    short = lambda: tgeo.energy_path(metric, mu1, mu2, n_points=10,  # noqa: E731
                                     n_iters=GEO_PROFILE_ITERS)
    short()
    torch.cuda.synchronize()
    t = time.perf_counter()
    short()
    torch.cuda.synchronize()
    interp["warm_host_ms_per_step"] = (time.perf_counter() - t) * 1e3 / GEO_PROFILE_ITERS
    busy_ms, kernels = device_time_by_kernel(torch, short)
    interp["device_ms_per_step"] = busy_ms / GEO_PROFILE_ITERS
    interp["device_busy_share"] = interp["device_ms_per_step"] / interp["warm_host_ms_per_step"]
    interp["kernel_launches_per_step"] = sum(k["calls"] for k in kernels) / GEO_PROFILE_ITERS
    interp["top_kernels"] = kernels[:8]
    out["interpolate"] = interp
    laps["interpolate"] = time.perf_counter() - t_phase

    # 2. the geodesic_exact prior: sample_latent, then a 64-request bucket
    t = time.perf_counter()
    z, counts = counted(torch, lambda: torch.from_numpy(
        manager.sample_latent(SERVE_BATCH, "geodesic_exact", seed=GEO_EXACT_SEED)))
    exact = {"sample_latent_host_s": time.perf_counter() - t, "launches": counts}
    check(counts == expected_launches(metric_bundle=GEO_EXACT_ITERS, g_inv=1),
          f"sample_latent(geodesic_exact) launched {counts}")
    add_counts(total, counts)
    noise = model.draw_generation_noise(SERVE_BATCH, "geodesic_exact",
                                        manager._generator(GEO_EXACT_SEED))
    exact["sample_latent_vs_cpu"] = exact_prior_replay(torch, metric, cpu_metric, z, noise)
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(SERVE_BATCH,),
                                                              max_wait_ms=2000),
                                         generate_method="geodesic_exact")
    seeds = list(range(100, 100 + SERVE_BATCH))
    try:
        engine.warmup({"generate": np.uint32(0)})
        torch.cuda.synchronize()
        zero_launch_counts()
        stats0 = engine.stats_snapshot()
        t = time.perf_counter()
        futs = [engine.submit("generate", np.uint32(s)) for s in seeds]
        rows = [f.result(timeout=120) for f in futs]
        exact["bucket_host_s"] = time.perf_counter() - t
        counts = launch_counts()
        batches = engine.stats_snapshot()["batches"] - stats0["batches"]
    finally:
        engine.stop()
    check(batches == 1, f"the {SERVE_BATCH} geodesic_exact requests took {batches} dispatches")
    check(counts == expected_launches(metric_bundle=GEO_EXACT_ITERS, g_inv=1, iaf_chain_fwd=1),
          f"the geodesic_exact bucket launched {counts}")
    add_counts(total, counts)
    exact["bucket_launches"] = counts
    for r in rows:
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad geodesic_exact row")
    direct = manager.sample_random_batched_seeds(seeds, method="geodesic_exact")
    exact["bucket_vs_direct_call"] = float(np.abs(np.stack(rows) - direct).max())
    check(exact["bucket_vs_direct_call"] == 0.0, "the engine's rows differ from a direct call")
    bucket_noise = concat_rows([model.draw_generation_noise(1, "geodesic_exact",
                                                            manager._generator(s))
                                for s in seeds])
    with torch.no_grad():
        z_bucket = model.sample_riemannian_prior(SERVE_BATCH, "geodesic_exact",
                                                 noise=bucket_noise)
    exact["bucket_vs_cpu"] = exact_prior_replay(torch, metric, cpu_metric, z_bucket, bucket_noise)
    out["geodesic_exact"] = exact
    laps["geodesic_exact"] = time.perf_counter() - t_phase

    # 3. Christoffel symbols, exp_map, log_map and shooting on 64 centroid pairs
    i1 = torch.arange(GEO_PAIRS) % metric.n_centroids
    i2 = (i1 + 1 + torch.arange(GEO_PAIRS) // metric.n_centroids) % metric.n_centroids
    z0, z1 = metric.centroids[i1.to(dev)], metric.centroids[i2.to(dev)]
    shots = {}
    with torch.no_grad():
        gam, counts = counted(torch, lambda: tgeo.christoffel(metric, z0))
        check(counts == expected_launches(metric_bundle=1), f"christoffel launched {counts}")
        add_counts(total, counts)
        shots["christoffel_rel"] = _scaled(gam, tgeo.christoffel(cpu_metric, z0.cpu()), 0.0)
        t = time.perf_counter()
        (end, path), counts = counted(torch, lambda: tgeo.exp_map(metric, z0, z1 - z0,
                                                                  return_path=True))
        shots["exp_map_host_s"] = time.perf_counter() - t
        check(counts == expected_launches(metric_bundle=4 * 32), f"exp_map launched {counts}")
        add_counts(total, counts)
        end_cpu, path_cpu = tgeo.exp_map(cpu_metric, z0.cpu(), (z1 - z0).cpu(), return_path=True)
        shots["exp_map"] = max(_scaled(end, end_cpu), _scaled(path, path_cpu))
    t = time.perf_counter()
    v, counts = counted(torch, lambda: tgeo.log_map(metric, z0, z1, **GEO_SHOOT))
    shots["log_map_host_s"] = time.perf_counter() - t
    n, it = GEO_SHOOT["n_steps"], GEO_SHOOT["n_iters"]
    want_b6 = 120 + 4 * n * (1 + 2 * it)  # the energy init, the start, 2 shots per iteration
    check(counts == expected_launches(metric_bundle=want_b6), f"log_map launched {counts}")
    add_counts(total, counts)
    shots["log_map_launches"] = counts
    t = time.perf_counter()
    geo, counts = counted(torch, lambda: tgeo.geodesic_interpolate(
        metric, z0, z1, n_points=GEO_SHOOT_POINTS, method="shooting", **GEO_SHOOT))
    shots["shooting_host_s"] = time.perf_counter() - t
    seg = GEO_SHOOT_POINTS - 1
    replay_steps = -(-n // seg) * seg  # the replay at a multiple of the segments, >= n
    check(counts == expected_launches(metric_bundle=want_b6 + 4 * replay_steps),
          f"shooting launched {counts}")
    add_counts(total, counts)
    check(bool(torch.isfinite(v).all()) and bool(torch.isfinite(geo).all()),
          "non-finite log_map or shooting path")
    with torch.no_grad():
        hit = tgeo.exp_map(metric, z0, v, n_steps=n)
    shots["shooting_residual_median"] = float((hit - z1).norm(dim=-1).median())
    # the CPU's log_map of the first rows, and its shooting path replayed
    # from that velocity as geodesic_interpolate replays it (one log_map on
    # the CPU serves both: it is the costly part)
    rows = slice(0, GEO_LOG_REPLAY_ROWS)
    v_cpu = tgeo.log_map(cpu_metric, z0[rows].cpu(), z1[rows].cpu(), **GEO_SHOOT)
    with torch.no_grad():
        _, geo_cpu = tgeo.exp_map(cpu_metric, z0[rows].cpu(), v_cpu, n_steps=replay_steps,
                                  return_path=True)
    geo_cpu = geo_cpu[:, ::replay_steps // seg]
    shots["log_map"] = _scaled(v[rows], v_cpu)
    shots["shooting"] = _scaled(geo[rows], geo_cpu)
    for key in ("christoffel_rel", "exp_map", "log_map", "shooting"):
        check(shots[key] <= GEO_TOL[key], f"{key}: card vs CPU {shots[key]} > {GEO_TOL[key]}")
    out["shooting"] = shots
    laps["shooting"] = time.perf_counter() - t_phase

    # 4. the Gaussian curvature on a grid of the centroids' PCA plane (plain path)
    basis, origin, grid = pca_plane(c.numpy(), GEO_CURV_GRID)
    t = time.perf_counter()
    curv, counts = counted(torch, lambda: tcurv.gaussian_curvature_2d(
        metric, torch.from_numpy(basis).to(dev), torch.from_numpy(origin).to(dev),
        torch.from_numpy(grid).to(dev)))
    curv_s = time.perf_counter() - t
    check(counts == expected_launches(), f"the curvature launched {counts}")
    curv_cpu = tcurv.gaussian_curvature_2d(cpu_metric, torch.from_numpy(basis),
                                           torch.from_numpy(origin), torch.from_numpy(grid))
    curv_err = _scaled(curv, curv_cpu, 0.0)
    check(bool(torch.isfinite(curv).all()) and curv_err <= GEO_TOL["curvature"],
          f"curvature: card vs CPU {curv_err}")
    out["curvature"] = {"grid": GEO_CURV_GRID, "host_s": curv_s, "max_rel_err": curv_err,
                        "k_min": float(curv_cpu.min()), "k_max": float(curv_cpu.max())}
    laps["curvature"] = time.perf_counter() - t_phase

    # 5. RHVAE metric pre-training at the published widths, warm-started
    frames_np = generate_cyclic_sequences(RHVAE_BATCH * RHVAE_STEPS // 8, seed=0)
    frames_np = frames_np.reshape(-1, 3, 64, 64)
    warm = {}
    for name, make in (("encoder", create_encoder), ("decoder", create_decoder)):
        net = make((3, 64, 64), 16)
        load_pretrained_net(net, PRETRAINED / f"{name}.npz")
        warm[name] = net.state_dict()
    rhvae = RHVAE().to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [rhvae.draw_noise(RHVAE_BATCH, gen, dev) for _ in range(RHVAE_STEPS)]
    steps = []

    def pre(module, args):
        if steps:
            steps[-1]["grad_norm"] = _grad_norm(torch, module)
        steps.append({"state": {k: v.detach().cpu().clone() for k, v in module.state_dict().items()},
                      "x": args[0].detach().cpu(),
                      "noise": {k: v.detach().cpu() for k, v in args[1].items()}})

    def post(module, args, result):
        steps[-1]["loss"] = float(result["loss"].detach())

    hooks = [rhvae.register_forward_pre_hook(pre), rhvae.register_forward_hook(post)]
    t = time.perf_counter()
    try:
        (learned, info), counts = counted(torch, lambda: train_metric(
            rhvae, frames_np, n_epochs=1, batch_size=RHVAE_BATCH, warm_start=warm, noise=draws))
    finally:
        for h in hooks:
            h.remove()
    train_s = time.perf_counter() - t
    steps[-1]["grad_norm"] = _grad_norm(torch, rhvae)
    g_inv_per_forward = 5 * 3 + 1  # (3 fixed-point + 2) per leapfrog step x 3, and the loss's
    check(counts == expected_launches(g_inv=RHVAE_STEPS * g_inv_per_forward),
          f"train_metric launched {counts}")
    add_counts(total, counts)
    check(len(steps) == RHVAE_STEPS and learned.n_centroids == RHVAE_BATCH * RHVAE_STEPS,
          f"{len(steps)} steps, K={learned.n_centroids}")
    cpu_rhvae = RHVAE()
    rh_errors = []
    for i, rec in enumerate(steps):
        cpu_rhvae.load_state_dict(rec["state"])
        cpu_rhvae.zero_grad(set_to_none=True)
        res = cpu_rhvae(rec["x"], rec["noise"])
        res["loss"].backward()
        loss_cpu, gn_cpu = float(res["loss"].detach()), _grad_norm(torch, cpu_rhvae)
        err = {"loss_rel": abs(rec["loss"] - loss_cpu) / abs(loss_cpu),
               "grad_norm_rel": abs(rec["grad_norm"] - gn_cpu) / gn_cpu,
               "loss": rec["loss"], "grad_norm": rec["grad_norm"]}
        rh_errors.append(err)
        check(np.isfinite(rec["loss"]) and err["loss_rel"] <= TRAIN_TOL["loss_rel"],
              f"RHVAE step {i + 1} loss: card vs CPU {err}")
        check(err["grad_norm_rel"] <= TRAIN_TOL["grad_norm_rel"],
              f"RHVAE step {i + 1} grad_norm: card vs CPU {err}")
    # one more forward and backward at the trained state, warm, on the host
    # clock and on CUDA events (not profiled: ~3e4 launches a step, each
    # costing the profiler more than the step itself)
    x_last = torch.from_numpy(frames_np[:RHVAE_BATCH]).to(dev)
    step = lambda: rhvae(x_last, draws[0])["loss"].backward()  # noqa: E731
    torch.cuda.synchronize()
    t = time.perf_counter()
    step()
    torch.cuda.synchronize()
    step_host_ms = (time.perf_counter() - t) * 1e3
    out["rhvae"] = {"steps": RHVAE_STEPS, "batch": RHVAE_BATCH, "train_s": train_s,
                    "launches": counts, "g_inv_per_step": counts["g_inv"] // RHVAE_STEPS,
                    "card_vs_cpu": rh_errors, "loss_history": info["loss_history"],
                    "n_centroids": learned.n_centroids, "warm_step_host_ms": step_host_ms,
                    "warm_step_event_ms": time_ms(torch, step, 1, warmup=0)}
    laps["rhvae"] = time.perf_counter() - t_phase

    # 6. the learned metric: saved, loaded, through the kernels and served
    with tempfile.TemporaryDirectory() as tmp:
        save_metric(learned, Path(tmp) / "metric.npz")
        loaded = load_metric(Path(tmp) / "metric.npz")
    check(torch.equal(loaded.centroids, learned.centroids)
          and torch.equal(loaded.matrices, learned.matrices)
          and (loaded.temperature, loaded.regularization)
          == (float(np.float32(learned.temperature)), float(np.float32(learned.regularization))),
          "the learned metric did not round-trip through save_metric/load_metric")
    lm = loaded.to(dev)
    zr = np.random.default_rng(12)
    zk = lm.centroids[torch.from_numpy(zr.integers(0, lm.n_centroids, SERVE_BATCH)).to(dev)]
    zk = (zk + 0.05 * torch.from_numpy(zr.normal(size=(SERVE_BATCH, 16))).float().to(dev))
    zk = zk.contiguous()
    bank = (lm.centroids, lm.matrices, 1.0 / lm.temperature ** 2)
    kern = {}
    l_k, ld_k = chol_bundle(zk, *bank, lm.regularization + 1e-6)
    l_p, ld_p = chol_bundle_ref(zk, *bank, lm.regularization + 1e-6)
    kern["chol_bundle"] = max(float((l_k - l_p).abs().max()), float((ld_k - ld_p).abs().max()))
    check(bool(torch.all((l_k - l_p).abs() <= CHOL_ATOL + CHOL_RTOL * l_p.abs())
               and torch.all((ld_k - ld_p).abs() <= CHOL_ATOL + CHOL_RTOL * ld_p.abs())),
          f"chol_bundle disagrees on the learned metric: {kern['chol_bundle']}")
    got, plain = metric_bundle(zk, *bank, lm.regularization), metric_bundle_ref(
        zk, *bank, lm.regularization)
    for name, k_out, p_out in zip(("g_inv", "l", "logdet", "g"), got, plain):
        rtol, atol = BUNDLE_TOL[name]
        check(bool(torch.all((k_out - p_out).abs() <= atol + rtol * p_out.abs())),
              f"metric_bundle {name} disagrees on the learned metric")
    kern["metric_bundle"] = max(float((k - p).abs().max()) for k, p in zip(got, plain))
    gi_k, gi_p = g_inv(zk, *bank, lm.regularization), g_inv_ref(zk, *bank, lm.regularization)
    kern["g_inv"] = float((gi_k - gi_p).abs().max())
    check(bool(torch.all((gi_k - gi_p).abs() <= 1e-6 + 1e-5 * gi_p.abs())),
          f"g_inv disagrees on the learned metric: {kern['g_inv']}")
    log_eps = float(np.log(np.float32(1e-10)))
    lp_k, gr_k = hmc_terms(zk, *bank, lm.regularization, log_eps)
    lp_p, gr_p = hmc_terms_ref(zk, *bank, lm.regularization, log_eps)
    g_scale = float(gr_p.abs().max().clamp_min(1e-30))
    kern["hmc_terms"] = {"log_pi_abs": float((lp_k - lp_p).abs().max()),
                         "grad_rel": float((gr_k - gr_p).abs().max()) / g_scale}
    check(kern["hmc_terms"]["log_pi_abs"] <= HMC_LP_ATOL
          and kern["hmc_terms"]["grad_rel"] <= HMC_RTOL,
          f"hmc_terms disagrees on the learned metric: {kern['hmc_terms']}")
    model.set_metric(lm)
    rng = np.random.default_rng(13)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(SERVE_BATCH,),
                                                              max_wait_ms=2000),
                                         generate_method="official")
    served = {}
    try:
        engine.warmup({"reconstruct": seqs[0], "generate": np.uint32(0)})
        for op, items, per_batch in (
                ("reconstruct", list(seqs), expected_launches(chol_bundle=2, iaf_chain_fwd=1)),
                ("generate", [np.uint32(s) for s in range(SERVE_BATCH)],
                 expected_launches(hmc_terms=CHAIN_LAUNCHES, iaf_chain_fwd=1))):
            torch.cuda.synchronize()
            zero_launch_counts()
            b0 = engine.stats_snapshot()["batches"]
            t = time.perf_counter()
            res = [f.result(timeout=120) for f in [engine.submit(op, it) for it in items]]
            host_s = time.perf_counter() - t
            counts = launch_counts()
            batches = engine.stats_snapshot()["batches"] - b0
            check(batches == 1 and counts == per_batch,
                  f"{op} on the learned metric: {batches} batches, launches {counts}")
            check(all(r.shape == (8, 3, 64, 64) and np.isfinite(r).all() for r in res),
                  f"bad {op} result on the learned metric")
            add_counts(total, counts)
            served[op] = {"host_s": host_s, "launches": counts}
    finally:
        engine.stop()
    out["learned_metric"] = {"n_centroids": lm.n_centroids, "temperature": lm.temperature,
                             "kernels_vs_plain": kern, "served": served}
    laps["learned_metric"] = time.perf_counter() - t_phase
    out.update({"launches": total, "laps_s": laps, "tolerances": GEO_TOL,
                "nvidia_smi": nvidia_smi()})
    return out


# ---------------------------------------------------------------------------
# dp phase
# ---------------------------------------------------------------------------

DP_STEPS = 1  # 3 until the seq_bwd phase joined the run, 2 until the viz phase did (its time)
DP_TRAIN_ROWS = 48   # the epoch's sequences: 24 per rank, 3 steps of 8 rows on each (a chunk
                     # of 2 and a ragged one in the chunked staging); 64 until the viz phase
DP_LAYOUTS = "1,2"   # the gloo world's meshes: 2 x 1 (DP) and 1 x 2 (DP x TP)
# more models in the gloo world: a BatchNorm model's step on 2 x 1, and the
# fast preset (fused decode+MSE) on 1 x 2, its decoder's output layer
# gathered over the model group for the kernel
DP_EXTRA = {"cnn_rlvae": 1, "riemannian_flow_vae_fast": 2}
DP_SERVE_DEVICES = ("cuda:0", "cuda:0")
DP_SERVE_BUCKET = 3  # a bucket the two replicas do not divide
DP_SERVE_TOL = 1e-4  # max |row - one replica's row| of reconstruct, encode and decode


def dp_verify_run(tmp: str, name: str, argv) -> dict:
    """``python -m rlvae_tpu_torch.parallel.dp_verify`` in-process (its ranks
    are subprocesses); its summary with the host seconds it took."""
    from rlvae_tpu_torch.parallel import dp_verify

    out = Path(tmp) / name
    t0 = time.perf_counter()
    rc = dp_verify.main([*argv, "--out", str(out)])
    summary = json.loads((out / "summary.json").read_text()) if (out / "summary.json").exists() \
        else {"ok": False, "layouts": {}}
    check(rc == 0 and summary["ok"],
          f"dp_verify {name}: {[v.get('failures') for v in summary['layouts'].values()]} "
          f"(rank logs under {out})")
    summary["host_s"] = time.perf_counter() - t0
    return summary


def _dp_step_figures(layout: dict) -> dict:
    """Per-rank step ms, the flat all-reduce's ms and share of it, and the
    profiled step's busy share."""
    step_ms = [1e3 * s for s in layout["step_s"]]
    ar_ms = [1e3 * s for s in layout["all_reduce_s"]]
    out = {"step_ms": step_ms, "all_reduce_ms": ar_ms,
           "all_reduce_share": [a / s for a, s in zip(ar_ms, step_ms)],
           "all_reduce_bytes": layout["collectives"]["all-reduce"]["bytes"],
           "param_bytes": layout["param_bytes"]}
    if "busy_ms" in layout:
        out["busy_share"] = [b / (1e3 * s) for b, s in zip(layout["busy_ms"],
                                                          layout["profiled_step_s"])]
    return out


def run_dp(torch, dev=None):
    """The data-parallel path: an NCCL world of one rank and a gloo world of
    two ranks on ``cuda:0`` through ``dp_verify`` (the default preset at full
    width, global B=16), then data-parallel serving over two replicas on
    ``cuda:0``.  ``dev`` the CPU rehearses it there (gloo for both worlds)."""
    cpu = dev is not None and torch.device(dev).type == "cpu"
    kind, one_rank_backend = ("cpu", "gloo") if cpu else ("cuda", "nccl")
    default = expected_launches()
    # each layout's launches per rank and step
    per_step = {"1": {**default, "chol_bundle": 2, "iaf_chain_fwd": 1, "iaf_chain_bwd": 1}}
    per_step.update({"2": per_step["1"], "cnn_rlvae": per_step["1"],
                     "riemannian_flow_vae_fast": {**default, "chol_bundle": 2,
                                                  "decode_mse_fwd": 1, "decode_mse_bwd_dh": 1,
                                                  "decode_mse_bwd_dw": 1}})
    common = ["--device", kind, "--model", "riemannian_flow_vae", "--batch", str(TRAIN_BATCH),
              "--steps", str(DP_STEPS), "--timeout", "400"]
    launches = {name: 0 for name in _wrappers()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        nccl = dp_verify_run(tmp, "nccl1", ["--world", "1", "--backend", one_rank_backend,
                                            "--epochs", "0", *common])
        check(nccl["layouts"]["1"]["steps_vs_plain"]["bitwise"],
              "the one-rank NCCL world's steps differ from the plain trainer's bits")
        gloo = dp_verify_run(tmp, "gloo2", ["--world", "2", "--backend", "gloo",
                                            "--model-parallel", DP_LAYOUTS, "--epochs", "1",
                                            "--train-rows", str(DP_TRAIN_ROWS),
                                            "--extra", ",".join(f"{n}@{m}" for n, m in
                                                                DP_EXTRA.items()), *common])
    for world, summary in (("nccl1", nccl), ("gloo2", gloo)):
        for name, layout in summary["layouts"].items():
            for r, steps in enumerate(layout["launches"]):
                for i, counts in enumerate(steps):
                    check(counts == (dict.fromkeys(default, 0) if cpu else per_step[name]),
                          f"{world} layout {name} rank {r} step {i + 1} launched {counts}")
                    add_counts(launches, counts)
    dp = gloo["layouts"]["1"]
    check(dp["collectives"]["all-reduce"] == dp["plan"]["all-reduce"]
          and dp["collectives"]["all-gather"]["count"] == 0,
          f"the DP step's collectives {dp['collectives']} are not the plan {dp['plan']}")
    check(dp["rows_equal_host_epoch_perm"] and dp["chunked_equals_resident"],
          "a rank's epoch rows are not its host_epoch_perm column")
    serve = run_dp_serving(torch, ("cpu", "cpu") if cpu else DP_SERVE_DEVICES, cpu)
    add_counts(launches, serve["launches"])
    # the counts measured on rank 0's first step of each layout
    measured = {f"{world}_{name}": layout["launches"][0][0]
                for world, summary in (("nccl1", nccl), ("gloo2", gloo))
                for name, layout in summary["layouts"].items()}
    return {"launches": launches, "launches_per_step": measured, "serving": serve,
            "nccl_world_1": {"host_s": nccl["host_s"], "steps_vs_plain":
                             nccl["layouts"]["1"]["steps_vs_plain"],
                             **_dp_step_figures(nccl["layouts"]["1"])},
            "gloo_world_2": {"host_s": gloo["host_s"],
                             **{name: {k: layout.get(k) for k in (
                                 "mesh", "collectives", "plan", "steps_vs_plain", "epochs",
                                 "rows_equal_host_epoch_perm", "chunked_equals_resident",
                                 "bn_vs_shard_mean_rel", "bn_shard_vs_plain_rel",
                                 "tolerances", "model")}
                                | _dp_step_figures(layout)
                                for name, layout in gloo["layouts"].items()}}}


def run_dp_serving(torch, devices=DP_SERVE_DEVICES, cpu: bool = False):
    """``BatchingEngine.from_manager(..., devices=["cuda:0", "cuda:0"])``:
    one bucket of each op, every row against the one-device manager's."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig

    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0,
                                       device=devices[0])
    rng = np.random.default_rng(11)
    n = DP_SERVE_BUCKET
    x = rng.uniform(size=(n, 8, 3, 64, 64)).astype(np.float32)
    z = rng.normal(size=(n, 16)).astype(np.float32)
    seeds = np.uint32(SERVE_SEEDS[:n])
    items = {"reconstruct": x, "encode": x[:, 0], "decode": z, "generate": seeds}
    want = {"reconstruct": manager.reconstruct(x, seed=0),
            "encode": manager.encode(x[:, 0]).embedding, "decode": manager.decode(z),
            "generate": manager.sample_random_batched_seeds(seeds)}
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(n,), max_wait_ms=2000),
                                         devices=devices)
    got, host_ms, per_op, launches = {}, {}, {}, {name: 0 for name in _wrappers()}
    try:
        for op, batch in items.items():
            t0 = time.perf_counter()

            def dispatch(op=op, batch=batch):
                futs = [engine.submit(op, row) for row in batch]
                return np.stack([f.result(timeout=300) for f in futs])

            got[op], per_op[op] = counted(torch, dispatch)
            host_ms[op] = (time.perf_counter() - t0) * 1e3
            add_counts(launches, per_op[op])
        stats = engine.stats_snapshot()
        ndev = {op: engine.ops[op].last_out_ndev for op in items}
    finally:
        engine.stop()
    check(stats["batches"] == len(items), f"{stats['batches']} dispatches for {len(items)} ops")
    check(all(v == len(devices) for v in ndev.values()), f"replicas used: {ndev}")
    errors = {op: float(np.abs(got[op] - want[op]).max()) for op in items}
    errors["generate_mean_abs"] = float(np.abs(got["generate"] - want["generate"]).mean())
    for op in ("reconstruct", "encode", "decode"):
        check(errors[op] <= DP_SERVE_TOL, f"DP serving {op}: {errors[op]} from one replica")
    check(errors["generate"] <= GEN_ROW_TOL["max_abs"]
          and errors["generate_mean_abs"] <= GEN_ROW_TOL["mean_abs"],
          f"DP serving generate rows: {errors}")
    for op in ("reconstruct", "generate"):
        check(cpu or per_op[op]["iaf_chain_fwd"] > 0, f"DP serving {op} launched no IAF chain")
    check(cpu or per_op["reconstruct"]["chol_bundle"] > 0, "DP serving launched no chol-bundle")
    return {"devices": list(devices), "bucket": n, "launches": launches,
            "launches_per_op": per_op,
            "max_abs_vs_one_replica": errors, "tolerance": {"rows": DP_SERVE_TOL,
                                                            "generate": GEN_ROW_TOL},
            "host_ms": host_ms}


# ---------------------------------------------------------------------------
# fixedpoint phase
# ---------------------------------------------------------------------------

FIXEDPOINT_ITERS = 8  # the default preset's flow_fixedpoint_iters in this phase
# the B=64 forward against the CPU: E2E_TOL, but the bf16 encoder's mu and
# log_var, z0 = mu + L eps, and the latents the flows carry z0's error to
# (relative to each step's scale), within one bf16 step (2^-8): on this
# phase's batch the two devices' roundings of mu part by 1.3e-3, over
# E2E_TOL's 1e-3, which was set on the serve phase's batch.  The chain
# itself is held at IAF_RTOL from the card's own z0 (chain_vs_cpu).
FIXEDPOINT_E2E_TOL = {**E2E_TOL, "mu": 2 ** -8, "log_var": 2 ** -8, "z0": 2 ** -8,
                      "z_rel": 2 ** -8}


def run_fixedpoint(torch, dev=None):
    """The default preset with ``flow_fixedpoint_iters: 8``: Trainer steps
    (chol-bundle 2, the Jacobi IAF-chain forward and its backward at 9
    sweeps, each replayed on the CPU's plain Jacobi chain), the validation
    pass (G^{-1}); one B=64 ``reconstruct`` bucket (chol-bundle 2, the Jacobi
    forward 1) and a B=64 forward against the CPU; then, outside the counted
    runs, the Jacobi chain's deviation from the sequential one at K=8 on the
    bucket's latents (``fixedpoint_error`` per transition, and the two
    kernels' chains), reported and not gated: convergence below D - 1
    iterations depends on the weights."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
    from rlvae_tpu_torch.flows import fixedpoint_error
    from rlvae_tpu_torch.ops.iaf_kernels import iaf_chain_fwd, stack_chain

    preset = {**PRESETS["riemannian_flow_vae"], "flow_fixedpoint_iters": FIXEDPOINT_ITERS}
    train = run_train(torch, preset, dev=dev)

    manager = ModelManager.from_config(preset, seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    check(manager.model.flows.fixedpoint_iters == FIXEDPOINT_ITERS, "the Jacobi mode was not set")
    rng = np.random.default_rng(8)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    engine = BatchingEngine.from_manager(
        manager, ServeConfig(buckets=(SERVE_BATCH,), max_wait_ms=2000))
    try:
        engine.warmup({"reconstruct": seqs[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        rows = [f.result(timeout=60) for f in [engine.submit("reconstruct", s_) for s_ in seqs]]
        bucket_ms = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(stats["batches"] == 1, f"the {SERVE_BATCH} requests took {stats['batches']} dispatches")
    check(counts == expected_launches(chol_bundle=2, iaf_chain_fwd=1),
          f"one Jacobi reconstruct batch launched {counts}")
    for r in rows:
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad reconstruct result")

    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, 16)), dtype=torch.float32)
    out_gpu = manager.forward(seqs, eps=eps.to(manager.device))
    torch.cuda.synchronize()
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    compare = compare_forward(torch, out_gpu, cpu.forward(seqs, eps=eps), FIXEDPOINT_E2E_TOL)
    forward = profile_forward(torch, manager, seqs, {"eps": eps.to(manager.device)})

    flows = manager.model.flows
    chain = [flows.flows[min(t, flows.n_flows - 1)] for t in range(N_TRANSITIONS)]
    z = out_gpu["z"].float()
    # the Jacobi chain alone: the card's latents against the CPU's plain
    # Jacobi chain from the card's own z0
    cpu_chain = [cpu.model.flows.flows[min(t, flows.n_flows - 1)] for t in range(N_TRANSITIONS)]
    with torch.no_grad():
        z_cpu, _ = iaf_chain_fwd(z[:, 0].cpu().contiguous(), *stack_chain(cpu_chain),
                                 fp_iters=FIXEDPOINT_ITERS)
    chain_err = _scaled_err(z[:, 1:].transpose(0, 1).cpu(), z_cpu)
    check(chain_err <= IAF_RTOL, f"the card's Jacobi chain vs the CPU's: {chain_err}")
    per_transition = [fixedpoint_error(iaf, z[:, t].contiguous(), FIXEDPOINT_ITERS)
                      for t, iaf in enumerate(chain)]
    z_j, ld_j = iaf_chain_fwd(z[:, 0].contiguous(), *stack_chain(chain), fp_iters=FIXEDPOINT_ITERS)
    z_s, ld_s = iaf_chain_fwd(z[:, 0].contiguous(), *stack_chain(chain))
    return {
        "model": "riemannian_flow_vae", "flow_fixedpoint_iters": FIXEDPOINT_ITERS,
        "train": train,
        "reconstruct_bucket": {"batch": SERVE_BATCH, "host_ms": bucket_ms, "launches": counts,
                               "stats": {k: v for k, v in stats.items()
                                         if not k.endswith("_hist")}},
        "cuda_vs_cpu": compare, "forward_b64": forward,
        "chain_vs_cpu": {"z_max_rel_err": chain_err, "tolerance": IAF_RTOL},
        "fixedpoint_error_k8": {
            "per_transition_max_rel_y_and_abs_logdet": per_transition,
            "chain_vs_sequential_kernel": {"z_max_rel_err": _scaled_err(z_j, z_s),
                                           "ld_max_abs_err": float((ld_j - ld_s).abs().max())},
            "gated": False},
        "launches": {k: counts[k] + train["launches"][k] for k in counts},
    }


# ---------------------------------------------------------------------------
# seq_bwd phase
# ---------------------------------------------------------------------------

SEQ_BWD_STEPS = 3
# the two backward modes' gradients of one batch on the card: JAX's
# grad_probe deviation (scripts/bench_iaf_fixedpoint.py), max over the
# parameters of max|g_seq - g_adj| / max(1e-3, max|g_adj|).  The modes
# differ only in the flows' fp32 summation order; an H100 read 3.4e-6
SEQ_GRAD_TOL = 1e-4


def seq_grad_probe(torch, dev):
    """The default preset's gradients on one B=16 batch and noise, with the
    sequential backward and with the adjoint, on the same weights."""
    from rlvae_tpu_torch.models import PRESETS, create_model
    from rlvae_tpu_torch.ops import iaf_kernels

    model = create_model(PRESETS["riemannian_flow_vae"], seed=0).to(dev)
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.uniform(size=(TRAIN_BATCH, 8, 3, 64, 64)), dtype=torch.float32,
                     device=dev)
    noise = {"eps": torch.tensor(rng.normal(size=(TRAIN_BATCH, 16)), dtype=torch.float32,
                                 device=dev)}
    grads, counts = {}, {}
    prev = iaf_kernels.ADJ_SWEEPS_OVERRIDE
    for label, sweeps in (("sequential", 0), ("adjoint", None)):
        iaf_kernels.ADJ_SWEEPS_OVERRIDE = sweeps
        try:
            model.zero_grad(set_to_none=True)
            before = (launch_counts()["iaf_chain_bwd"], sequential_bwd_launches())
            model(x, noise, train=True).loss.backward()
            torch.cuda.synchronize()
            counts[label] = {"all": launch_counts()["iaf_chain_bwd"] - before[0],
                             "sequential": sequential_bwd_launches() - before[1]}
            grads[label] = [p.grad.detach().clone() for p in model.parameters()
                            if p.grad is not None]
        finally:
            iaf_kernels.ADJ_SWEEPS_OVERRIDE = prev
    worst = max(float((a - b).abs().max()) / max(1e-3, float(b.abs().max()))
                for a, b in zip(grads["sequential"], grads["adjoint"]))
    return {"max_scaled_grad_dev": worst, "tolerance": SEQ_GRAD_TOL,
            "iaf_chain_bwd_launches": counts, "parameters": len(grads["adjoint"])}


def run_seq_bwd(torch, dev=None):
    """The default preset's training with the IAF-chain backward in its
    sequential mode (``ADJ_SWEEPS_OVERRIDE = 0``, as JAX's override forces
    ``adj_sweeps = 0``): SEQ_BWD_STEPS Trainer steps at B=16 (chol-bundle 2,
    IAF-chain forward and backward 1 each), each replayed on the CPU under
    the same override (its plain sequential backward), the validation pass
    (G^{-1}); then, outside the counted run, one batch's gradients in the
    two modes against each other."""
    from rlvae_tpu_torch.ops import iaf_kernels

    prev = iaf_kernels.ADJ_SWEEPS_OVERRIDE
    iaf_kernels.ADJ_SWEEPS_OVERRIDE = 0
    try:
        train = run_train(torch, steps=SEQ_BWD_STEPS, dev=dev)
    finally:
        iaf_kernels.ADJ_SWEEPS_OVERRIDE = prev
    check(train["iaf_chain_bwd_sequential_launches"] == train["launches"]["iaf_chain_bwd"] > 0,
          f"the seq_bwd run launched the backward {train['launches']['iaf_chain_bwd']} times, "
          f"{train['iaf_chain_bwd_sequential_launches']} in the sequential mode")
    probe = seq_grad_probe(torch, torch.device("cuda") if dev is None else dev)
    check(probe["iaf_chain_bwd_launches"] == {"sequential": {"all": 1, "sequential": 1},
                                              "adjoint": {"all": 1, "sequential": 0}},
          f"the probe's backward launches by mode: {probe['iaf_chain_bwd_launches']}")
    check(probe["max_scaled_grad_dev"] <= SEQ_GRAD_TOL,
          f"the sequential backward's gradients vs the adjoint's: {probe}")
    check(iaf_kernels.ADJ_SWEEPS_OVERRIDE is None, "ADJ_SWEEPS_OVERRIDE was not restored")
    return {"model": "riemannian_flow_vae", "adj_sweeps_override": 0, "train": train,
            "vs_adjoint": probe, "launches": train["launches"]}


# ---------------------------------------------------------------------------
# deploy phase
# ---------------------------------------------------------------------------

DEPLOY_BUCKETS = (1, SERVE_BATCH)
DEPLOY_OPS = ("reconstruct", "encode", "decode", "generate")
DEPLOY_PADDED = 3  # rows of a padded bucket: the last row (and its draws) repeated
DEPLOY_TIMED = 5   # host-clock repeats of each B=64 latency
# the registered ops in each exported program, and the kernels each
# program launches by profiler name: reconstruct the posterior's and the
# KL's chol-bundles and the chain, generate (geodesic prior) G^{-1} and the
# chain, encode and decode none of the port's
DEPLOY_GRAPH_OPS = {"reconstruct": {"chol_bundle": 2, "iaf_chain_fwd": 1},
                    "generate": {"g_inv": 1, "iaf_chain_fwd": 1}, "encode": {}, "decode": {}}
DEPLOY_KERNELS = {"reconstruct": {"B1": 2, "B2": 1}, "generate": {"B7": 1, "B2": 1},
                  "encode": {}, "decode": {}}


KERNEL_LABELS = {"chol_bundle": "B1", "iaf_chain_fwd": "B2", "metric_bundle": "B6",
                 "g_inv": "B7"}
PROFILE_ATTEMPTS = 2


def kernel_calls(kernels) -> dict:
    """Profiled launches of B1, B2, B6 and B7 from ``device_time_by_kernel``'s
    list (G^{-1} is ``metric_bundle_kernel<R, false>``, the bundle ``<R, true>``)."""
    calls = dict.fromkeys(("B1", "B2", "B6", "B7"), 0)
    for k in kernels:
        name = k["name"]
        if "chol_bundle_kernel" in name:
            calls["B1"] += k["calls"]
        elif "iaf_chain_fwd_kernel" in name:
            calls["B2"] += k["calls"]
        elif "metric_bundle_kernel" in name:
            calls["B7" if "false>" in name else "B6"] += k["calls"]
    return calls


def warm_profile(torch, fn):
    """Kernels of one call of ``fn`` (idempotent) by ``torch.profiler``, as
    :func:`device_time_by_kernel` lists them, taken in the active step of a
    schedule after a warm-up step that runs ``fn`` too: started cold in a
    process that had profiled before, a session's device events came back
    short (a B=64 ``encode`` program showed no kernel at all, a
    ``reconstruct`` 228 of its 259 launches, the first chol-bundle among
    the missing).  After the warm-up the long programs came back whole;
    the sub-millisecond ``encode`` and ``decode`` still partly or wholly
    missing.  Also the wrappers' counts of the active call.  Returns
    (device-busy ms, kernels, counted launches)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = launch_counts()
        fn()
        torch.cuda.synchronize()
        after = launch_counts()
        prof.step()
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        # the schedule's step range (ProfilerStep#N) spans the step's kernels
        if (us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower()
                and not evt.key.startswith("ProfilerStep")):
            kernels.append({"name": evt.key[:80], "us": float(us), "calls": int(evt.count)})
    kernels.sort(key=lambda k: -k["us"])
    counted = {label: after[name] - before[name] for name, label in KERNEL_LABELS.items()}
    return sum(k["us"] for k in kernels) / 1e3, kernels, counted


def profiled_launches(torch, fn):
    """One profiled call of ``fn`` (:func:`warm_profile`): (B1/B2/B6/B7
    launches by the profiler, the same by the wrappers' counters,
    device-busy ms, kernels, attempts).  A call whose profiled launches
    differ from the counted ones is profiled again, up to PROFILE_ATTEMPTS
    times; the counters give the exact counts."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        busy_ms, kernels, counted = warm_profile(torch, fn)
        calls = kernel_calls(kernels)
        if calls == counted:
            break
    return calls, counted, busy_ms, kernels, attempt


def deploy_run_dir(torch, manager, root: Path) -> Path:
    """A run directory of ``manager``'s weights as the app server reads one:
    the composed config (the default model, synthetic sprites cut to a few
    sequences) and a ``best`` slot."""
    from rlvae_tpu_torch.config import compose, save_config
    from rlvae_tpu_torch.train.checkpoints import CheckpointManager

    run_dir = root / "deploy_run"
    cfg = compose(CONF, "config", ["training=quick", "training.n_train_samples=8",
                                   "training.n_val_samples=4", "data.synthetic_n_train=8",
                                   "data.synthetic_n_test=4"])
    run_dir.mkdir(parents=True)
    save_config(cfg, run_dir / "config.yaml")
    CheckpointManager(run_dir / "checkpoints").save(
        "best", {"params": manager.model.state_dict(), "step": 0, "val_loss": 0.0})
    return run_dir


def _post(port: int, path: str, payload) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=300) as r:
        return json.loads(r.read())


def _host_ms(torch, fn, n: int = DEPLOY_TIMED) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def run_deploy(torch, dev=None):
    """The deployment surface on the default model at full width
    (pretrained nets, K=50 metric): ``export_model`` of the four ops at
    buckets (1, 64), ``load_exported``, every program against the live
    manager on the same inputs and draws (bit for bit: the same kernels),
    B1/B2/B7 launches per program counted by the profiler, one request per
    op through ``bundle_server`` over HTTP and one ``reconstruct`` and one
    ``generate`` through ``app_server``, and the B=64 bundle and eager
    latencies."""
    import importlib.util

    from rlvae_tpu_torch import ModelManager, PRESETS
    from rlvae_tpu_torch.bundle_server import serve_bundle
    from rlvae_tpu_torch.export import export_model, load_exported
    from rlvae_tpu_torch.viz.base import png_b64

    dev = dev or torch.device("cuda")
    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0, device=dev)
    rng = np.random.default_rng(24)
    b = SERVE_BATCH
    inputs = {"reconstruct": rng.uniform(size=(b, 8, 3, 64, 64)).astype(np.float32),
              "encode": rng.uniform(size=(b, 3, 64, 64)).astype(np.float32),
              "decode": rng.normal(size=(b, 16)).astype(np.float32),
              "generate": rng.integers(0, 2**32, size=b, dtype=np.uint32)}
    eager = {"reconstruct": lambda x: manager.reconstruct_rows(x, seed=0),
             "encode": lambda x: manager.encode_rows(x)["embedding"],
             "decode": manager.decode_rows,
             "generate": lambda s: manager.generate_rows(s, n_obs=8)}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as tmp:
        tmp = Path(tmp)
        t = time.perf_counter()
        manifest = export_model(manager, tmp / "bundle", ops=DEPLOY_OPS, buckets=DEPLOY_BUCKETS)
        export_s = time.perf_counter() - t
        for op in DEPLOY_OPS:
            for bucket, spec in manifest["programs"][op].items():
                want = {**dict.fromkeys(spec["registered_ops"], 0), **DEPLOY_GRAPH_OPS[op]}
                check(spec["registered_ops"] == want,
                      f"the exported {op} b{bucket} holds {spec['registered_ops']}")
        t = time.perf_counter()
        bundle = load_exported(tmp / "bundle", device=dev)
        load_s = time.perf_counter() - t
        bundle_bytes = sum(p.stat().st_size for p in (tmp / "bundle").iterdir())

        # warm both sides at every bucket
        for op in DEPLOY_OPS:
            for n in DEPLOY_BUCKETS:
                bundle.run(op, inputs[op][:n])
                eager[op](inputs[op][:n])
        torch.cuda.synchronize()

        # the main path, counted from zero: every program at a full bucket of
        # 64 and of 1 and a padded bucket, then one request per op through
        # the bundle server over HTTP (its engine pads to bucket 1)
        zero_launch_counts()
        cases = {op: {"b64": inputs[op], "b1": inputs[op][:1],
                      "padded": inputs[op][:DEPLOY_PADDED]} for op in DEPLOY_OPS}
        got = {op: {case: bundle.run(op, x) for case, x in c.items()} for op, c in cases.items()}
        httpd, engine = serve_bundle(bundle, port=0, max_wait_ms=2.0)
        http = {}
        try:
            port = httpd.server_address[1]
            ops = _get(port, "/ops")["ops"]
            check(ops == {op: list(DEPLOY_BUCKETS) for op in DEPLOY_OPS},
                  f"the bundle server lists {ops}")
            for op in DEPLOY_OPS:
                t = time.perf_counter()
                out = _post(port, f"/v1/{op}", {"items": [inputs[op][0].tolist()]})["outputs"]
                http[op] = {"ms": (time.perf_counter() - t) * 1e3,
                            "bitwise_vs_bundle": bool(np.array_equal(
                                np.asarray(out, np.float32), got[op]["b1"]))}
                check(http[op]["bitwise_vs_bundle"], f"the HTTP {op} differs from the bundle")
            http["stats"] = {k: v for k, v in _get(port, "/stats").items()
                             if not k.endswith("_hist")}
        finally:
            httpd.shutdown()
            engine.stop()
        torch.cuda.synchronize()
        launches = launch_counts()
        runs = len(cases["reconstruct"]) + 1  # of each op: three cases and one HTTP request
        check(launches == expected_launches(chol_bundle=2 * runs, iaf_chain_fwd=2 * runs,
                                            g_inv=runs),
              f"the bundle's programs launched {launches}; expected per run B1 2 and B2 1 "
              f"(reconstruct), B7 1 and B2 1 (generate), none (encode, decode)")

        # every program against the live manager on the same inputs and draws
        parity = {}
        for op in DEPLOY_OPS:
            x = inputs[op]
            padded = np.concatenate([x[:DEPLOY_PADDED]] + [x[DEPLOY_PADDED - 1:DEPLOY_PADDED]]
                                    * (b - DEPLOY_PADDED))
            if op == "reconstruct":  # the draws of 3 rows from seed 0, the last repeated
                noise = manager.model.draw_posterior_noise(
                    DEPLOY_PADDED, torch.Generator(device=dev).manual_seed(0))
                noise = {k: torch.cat([v, v[-1:].expand(b - DEPLOY_PADDED, *v.shape[1:])])
                         for k, v in noise.items()}
                padded_ref = manager.reconstruct_rows(padded, noise=noise)
            else:
                padded_ref = eager[op](padded)
            refs = {"b64": eager[op](x), "b1": eager[op](x[:1]),
                    "padded": padded_ref[:DEPLOY_PADDED]}
            parity[op] = {}
            for case, ref in refs.items():
                ref, out = ref.float().cpu().numpy(), got[op][case]
                parity[op][case] = {"bitwise": bool(np.array_equal(out, ref)),
                                    "max_abs": float(np.abs(out - ref).max()),
                                    "shape": list(out.shape)}
                check(parity[op][case]["bitwise"] and np.isfinite(out).all(),
                      f"the exported {op} ({case}) differs from the live manager: "
                      f"{parity[op][case]}")

        # launches per program beside the eager op's: the counters' exact
        # counts, and every expected kernel (and no other) seen by the
        # profiler, which may come back short (profiled_launches)
        programs = {}
        for op in DEPLOY_OPS:
            x = inputs[op]
            want = {**dict.fromkeys(KERNEL_LABELS.values(), 0), **DEPLOY_KERNELS[op]}
            rec = {}
            for side, fn in (("bundle", lambda: bundle.run_rows(op, x)),
                             ("eager", lambda: eager[op](x))):
                calls, counted, busy_ms, kernels, attempts = profiled_launches(torch, fn)
                check(counted == want, f"the {side} {op} launched {counted}; expected {want}")
                check(all((calls[k] > 0) == (want[k] > 0) and calls[k] <= want[k] for k in want),
                      f"the profiler saw the {side} {op} launch {calls}; expected {want}")
                rec[side] = {"kernels": calls, "counted": counted,
                             "profiler_complete": calls == counted,
                             "device_busy_ms": busy_ms,
                             "n_launches": sum(k["calls"] for k in kernels),
                             "profile_attempts": attempts,
                             "port_kernels": [k for k in kernels if any(
                                 n in k["name"] for n in PORTED_KERNEL_NAMES)]}
            programs[op] = {**rec["bundle"], "eager": rec["eager"]}

        # B=64 latency on the host clock, inputs uploaded and rows copied back
        latency = {}
        for op in ("reconstruct", "generate"):
            x = inputs[op]
            latency[op] = {"bundle_ms": _host_ms(torch, lambda: bundle.run(op, x)),
                           "eager_ms": _host_ms(torch, lambda: eager[op](x).float().cpu())}

        # the app server over a run directory of the same weights
        from rlvae_tpu_torch.app_server import serve

        deploy_run_dir(torch, manager, tmp / "outputs")
        server, state = serve(tmp / "outputs", port=0, block=False, device=dev)
        try:
            port = server.server_address[1]
            t = time.perf_counter()
            rec = _get(port, "/api/model/deploy_run/reconstruct?n=1")
            gen = _get(port, "/api/model/deploy_run/generate?n=1&seed=7")
            app_s = time.perf_counter() - t
            serving = _get(port, "/api/serving")["deploy_run"]
        finally:
            server.shutdown()
            state.close()
        want_gen = manager.sample_random_batched_seeds([7], n_obs=8)[0]
        check(len(rec["rows"]) == 2 and len(rec["rows"][0]) == 8 and len(gen["rows"]) == 1,
              f"the app server answered {len(rec['rows'])} reconstruct rows and "
              f"{len(gen['rows'])} generate rows")
        check(gen["rows"][0] == [png_b64(f) for f in want_gen],
              "the app server's generate row differs from the live manager's")
        check(serving["requests"] == 2, f"the app server's engine took {serving['requests']}")
        methods = run_deploy_methods(torch, dev, manager, tmp / "methods")

        report = None
        if importlib.util.find_spec("matplotlib") is not None:
            from rlvae_tpu_torch.app import build_report

            t = time.perf_counter()
            out = build_report(tmp / "outputs" / "deploy_run", n_samples=2, device=dev)
            report = {"bytes": out.stat().st_size, "s": time.perf_counter() - t}
            check("Model inference" in out.read_text(), "the dashboard lacks its inference page")
    return {"model": "riemannian_flow_vae", "buckets": list(DEPLOY_BUCKETS),
            "export_s": export_s, "load_s": load_s, "bundle_bytes": bundle_bytes,
            "torch_export_graph_ops": {op: manifest["programs"][op][str(b)]["registered_ops"]
                                       for op in DEPLOY_OPS},
            "parity": parity, "programs": programs, "http": http, "latency_b64": latency,
            "app_server": {"s": app_s, "engine": {k: v for k, v in serving.items()
                                                  if not k.endswith("_hist")}},
            "matplotlib": report is not None, "report": report, "launches": launches,
            "methods": methods}


# the deploy phase's exports of the other methods (run_deploy_methods): every
# prior method JAX's export_model exports but the two above at bucket 4 on
# the default model, and the hmc posterior's reconstruct on the hybrid
DEPLOY_METHODS = ("weighted_mixture", "geodesic_exact", "basic", "official", "hmc")
# (1, 4) until the latent_dims phase joined the run: bucket 1 was exported, never run
DEPLOY_METHOD_BUCKETS = (4,)
DEPLOY_METHOD_TIMED = 3  # host-clock repeats of each B=4 latency
# the registered ops each program holds (a loop body's once: a prior chain's
# step evaluates B4 16 times, a posterior step 10 times, an energy-path Adam
# step its gradient once) ...
DEPLOY_METHOD_GRAPH_OPS = {
    "weighted_mixture": {"chol_bundle": 2, "iaf_chain_fwd": 1},
    "geodesic_exact": {"energy_grad": 1, "g_inv": 1, "iaf_chain_fwd": 1},
    "basic": {"basic_grad": 10, "iaf_chain_fwd": 1},
    "official": {"hmc_terms": 1 + 16, "iaf_chain_fwd": 1},
    "hmc": {"hmc_terms": 1 + 16, "iaf_chain_fwd": 1},
    "hmc_posterior": {"hmc_terms": 10, "iaf_chain_fwd": 1},
}
# ... and what each call launches, the bundle's as the live manager's:
# basic's gradient B1 once per ascent step, geodesic_exact's energy path B6
# once per Adam step, a chain 1 + 100 x 16 B4, the posterior 20 x 5 x 2
DEPLOY_METHOD_LAUNCHES = {
    "weighted_mixture": {"chol_bundle": 2, "iaf_chain_fwd": 1},
    "geodesic_exact": {"metric_bundle": 80, "g_inv": 1, "iaf_chain_fwd": 1},
    "basic": {"chol_bundle": 10, "iaf_chain_fwd": 1},
    "official": {"hmc_terms": 1601, "iaf_chain_fwd": 1},
    "hmc": {"hmc_terms": 1601, "iaf_chain_fwd": 1},
    "hmc_posterior": {"hmc_terms": 200, "iaf_chain_fwd": 1},
}


def _counted(torch, fn):
    """(``fn()`` as numpy, the wrappers' launches of the call)."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return out.float().cpu().numpy(), {k: after[k] - before[k] for k in after}


def run_deploy_methods(torch, dev, manager, tmp: Path) -> dict:
    """The deploy phase's second part: ``export_model`` of ``generate`` by
    each of DEPLOY_METHODS on ``manager`` (the default model), and of
    ``reconstruct`` on the hybrid model with the ``hmc`` posterior, at
    DEPLOY_METHOD_BUCKETS; each bundle loaded on the card.  The counters are
    zeroed; then per program the live manager and the bundle at a full
    bucket of 4 (bit for bit), and at a padded bucket of 3 rows against the
    manager on the padded batch and draws (bit for bit), every call's
    launches equal to DEPLOY_METHOD_LAUNCHES (the chains' 1601 B4, the
    posterior's 200).  Then the B=4 latency of bundle and manager on the
    host clock.  No fallback: a registered op that fails to launch fails
    the phase."""
    from rlvae_tpu_torch import ModelManager
    from rlvae_tpu_torch.export import export_model, load_exported

    hybrid = ModelManager.from_config(hmc_hybrid_config(), seed=0, device=dev)
    rng = np.random.default_rng(26)
    seeds = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    x = rng.uniform(size=(4, 8, 3, 64, 64)).astype(np.float32)
    cases = {m: (manager, "generate", m) for m in DEPLOY_METHODS}
    cases["hmc_posterior"] = (hybrid, "reconstruct", "geodesic")
    bundles, out = {}, {}
    for name, (mgr, op, method) in cases.items():
        t = time.perf_counter()
        manifest = export_model(mgr, tmp / name, ops=(op,), buckets=DEPLOY_METHOD_BUCKETS,
                                generate_method=method)
        export_s = time.perf_counter() - t
        for bucket, spec in manifest["programs"][op].items():
            want = {**dict.fromkeys(spec["registered_ops"], 0), **DEPLOY_METHOD_GRAPH_OPS[name]}
            check(spec["registered_ops"] == want,
                  f"the exported {name} b{bucket} holds {spec['registered_ops']}")
        t = time.perf_counter()
        bundles[name] = load_exported(tmp / name, device=dev)
        out[name] = {"op": op, "export_s": export_s, "load_s": time.perf_counter() - t,
                     "program_bytes": sum(p.stat().st_size for p in (tmp / name).glob("*.pt2")),
                     "noise": manifest["noise"][op]}

    zero_launch_counts()
    for name, (mgr, op, _) in cases.items():
        bundle = bundles[name]
        if op == "generate":
            batch, padded = seeds, np.r_[seeds[:3], seeds[2]]
            eager_full = lambda: mgr.generate_rows(seeds, name)  # noqa: E731
            eager_padded = lambda: mgr.generate_rows(padded, name)  # noqa: E731
        else:
            batch, padded = x, np.concatenate([x[:3], x[2:3]])
            noise = mgr.model.draw_posterior_noise(3, torch.Generator(device=dev).manual_seed(0))
            axes = {s["name"]: s.get("row_axis", 0) for s in out[name]["noise"]}
            noise = {k: torch.cat([v, v.narrow(axes[k], 2, 1)], dim=axes[k])
                     for k, v in noise.items()}
            eager_full = lambda: mgr.reconstruct_rows(x, seed=0)  # noqa: E731
            eager_padded = lambda: mgr.reconstruct_rows(padded, noise=noise)  # noqa: E731
        want = {**dict.fromkeys(launch_counts(), 0), **DEPLOY_METHOD_LAUNCHES[name]}
        calls, parity = {}, {}
        ref_full, calls["eager_b4"] = _counted(torch, eager_full)
        got_full, calls["bundle_b4"] = _counted(torch, lambda: bundle.run_rows(op, batch))
        ref_pad, calls["eager_padded"] = _counted(torch, eager_padded)
        got_pad, calls["bundle_padded"] = _counted(torch, lambda: bundle.run_rows(op, batch[:3]))
        for case, (got, ref) in {"b4": (got_full, ref_full),
                                 "padded": (got_pad, ref_pad[:3])}.items():
            parity[case] = {"bitwise": bool(np.array_equal(got, ref)),
                            "max_abs": float(np.abs(got - ref).max()), "shape": list(got.shape)}
            check(parity[case]["bitwise"] and np.isfinite(got).all(),
                  f"the exported {name} ({case}) differs from the live manager: {parity[case]}")
        for call, counts in calls.items():
            check(counts == want, f"the {name} {call} call launched {counts}; expected {want}")
        out[name].update(parity=parity, launches_per_call={
            k: v for k, v in calls["bundle_b4"].items() if v})
    torch.cuda.synchronize()
    launches = launch_counts()

    # B=4 latency on the host clock, inputs uploaded and rows copied back
    for name, (mgr, op, _) in cases.items():
        batch = seeds if op == "generate" else x
        eager = ((lambda: mgr.generate_rows(seeds, name)) if op == "generate"
                 else (lambda: mgr.reconstruct_rows(x, seed=0)))
        out[name]["latency_b4"] = {
            "bundle_ms": _host_ms(torch, lambda: bundles[name].run(op, batch),
                                  DEPLOY_METHOD_TIMED),
            "eager_ms": _host_ms(torch, lambda: eager().float().cpu(), DEPLOY_METHOD_TIMED)}
    return {"models": {"generate": "riemannian_flow_vae", "hmc_posterior":
                       "hybrid_rlvae, sampling.method=hmc"},
            "buckets": list(DEPLOY_METHOD_BUCKETS), "programs": out, "launches": launches}


# ---------------------------------------------------------------------------
# viz phase
# ---------------------------------------------------------------------------

VIZ_CONFIG = CONF / "visualization" / "full.yaml"  # level FULL, curvature, fancy plots
VIZ_SEQS = 8  # the config's max_sequences: the hook's sample batch
# Card vs CPU, each field from the same latents, relative to max(1, |x|)
# unless said otherwise.  The metric fields come from the kernels on the card
# and their plain versions on the CPU: log det G^{-1} from the chol-bundle
# (kernels phase: |k - p| <= 1e-5 + 1e-4 |p|), G^{-1} and G from the metric
# kernels (G inverts G^{-1}, so its conditioning scales the error).
VIZ_TOL = {
    "logdet": 1e-4,        # log sqrt det G^{-1} and log det G^{-1} fields and paths
    "g_inv": 1e-5,         # G^{-1} along the trajectories, of its largest entry
    "g": 1e-3,             # G on the ellipse grid, of its largest entry
    "dist2": 1e-3,         # squared step lengths and the amplification field
    "spectra": 1e-3,       # the flows' Jacobian singular values (plain ops), relative
    "curvature": GEO_TOL["curvature"],     # second derivatives: of the largest |K|
    "energy_path": GEO_TOL["energy_path"],  # 120 Adam steps feed rounding back
    "length": GEO_TOL["energy_path"],      # the two paths' Riemannian lengths, relative
}
ZOO_DIM, ZOO_BATCH = 16, 64
ZOO_TOL = 1e-4  # the zoo's outputs and log-dets, of max(1, |x|)
PCNN_LOSS_BATCH, PCNN_SAMPLES = 16, 4
PCNN_CHECK_STEPS = (0, 1, 29, 391, 783)  # raster steps whose logits the CPU recomputes
PCNN_TOL = 1e-4  # logits, of their largest |x|
PCNN_TIE = 1e-3  # an argmax whose two best scores lie this close may flip (counted)
SLOPE_STACK = 64  # distinct B=64 inputs of scan_slope_time


class _VizData:
    """The data module the trainer's viz hook reads its sample batch from."""

    def __init__(self, x):
        self.x = x

    def get_sample_batch(self, split="val", n=8):
        return self.x[:n]


class _VizLog:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))

    def log_image(self, key, path):
        pass


def _field_err(got, want, floor=1.0) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"field shapes {got.shape} vs {want.shape}")
    return float(np.max(np.abs(got - want) / np.maximum(floor, np.abs(want))))


def _of_largest(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(1.0, float(np.abs(np.asarray(want)).max())))


def viz_module_fields(torch, card, cpu, z, cfg, out_dir):
    """Each plotting module's fields from latents ``z`` on the card and on
    the CPU (the same ``z``), held to VIZ_TOL; per module the card's host
    seconds and launches, the CPU's seconds, and each field's error."""
    from rlvae_tpu_torch.viz.flow_analysis import FlowAnalysisVisualizations
    from rlvae_tpu_torch.viz.interactive import InteractiveVisualizations
    from rlvae_tpu_torch.viz.manifold import ManifoldVisualizations

    dev = next(card.parameters()).device
    gen_noise = card.draw_generation_noise(4, "geodesic",
                                           torch.Generator(device=dev).manual_seed(1))
    runs = {"manifold": (ManifoldVisualizations, lambda m, mod, noise: mod.fields(m, z)),
            "flow_analysis": (FlowAnalysisVisualizations, lambda m, mod, noise: mod.fields(m, z)),
            "interactive": (InteractiveVisualizations,
                            lambda m, mod, noise: mod.fields(m, z, noise=noise))}
    out, fields, total = {}, {}, {}
    for name, (cls, fn) in runs.items():
        mod = cls(cfg, out_dir, None)
        t = time.perf_counter()
        got, counts = counted(torch, lambda: fn(card, mod, gen_noise))
        host_s = time.perf_counter() - t
        t = time.perf_counter()
        want = fn(cpu, mod, {k: v.cpu() for k, v in gen_noise.items()})
        out[name] = {"host_s": host_s, "cpu_s": time.perf_counter() - t, "launches": counts}
        fields[name] = (got, want)
        add_counts(total, counts)

    errs = {}
    (gm, wm), (gf, wf), (gi, wi) = fields["manifold"], fields["flow_analysis"], fields["interactive"]
    errs["manifold"] = {"vals": _field_err(gm["vals"], wm["vals"]),
                        "dets": _field_err(gm["dets"], wm["dets"]),
                        "g_inv": _of_largest(gm["g_inv"], wm["g_inv"]),
                        "curv": _of_largest(gm["curv"], wm["curv"])}
    errs["flow_analysis"] = {
        "spectra": max(float(np.max(np.abs(a - b) / np.abs(b))) for a, b in
                       zip(gf["spectra"], wf["spectra"])),
        "dets": _field_err(gf["dets"], wf["dets"]),
        "logdet": _field_err(gf["logdet"], wf["logdet"])}
    fc, fw = gi["fancy"], wi["fancy"]
    errs["interactive"] = {
        "geodesic_frames": float(np.abs(gi["geodesic_frames"] - wi["geodesic_frames"]).max()),
        "geodesic_frames_mean": float(np.abs(gi["geodesic_frames"]
                                             - wi["geodesic_frames"]).mean()),
        "metric_slider": _field_err(gi["metric_slider"]["vals"], wi["metric_slider"]["vals"]),
        "temporal_field": _field_err(gi["temporal"]["field"], wi["temporal"]["field"]),
        "temporal_dets": _field_err(gi["temporal"]["dets"], wi["temporal"]["dets"]),
        "det_field": _field_err(fc["det_field"], fw["det_field"]),
        "det_path": _field_err(fc["det_path"], fw["det_path"]),
        "g_full": _of_largest(fc["g_full"], fw["g_full"]),
        "riem": _field_err(fc["riem"] ** 2, fw["riem"] ** 2),
        "amp2": _field_err(fc["amp2"], fw["amp2"]),
        "energy_path": _field_err(fc["geodesic"]["geo"], fw["geodesic"]["geo"]),
        "lengths": max(abs(fc["geodesic"][k] - fw["geodesic"][k]) / abs(fw["geodesic"][k])
                       for k in ("l_g", "l_l")),
        "curv": _of_largest(fc["curvature"]["curv"], fw["curvature"]["curv"]),
        "generated": float(np.abs(gi["generated"] - wi["generated"]).max()),
        "generated_mean": float(np.abs(gi["generated"] - wi["generated"]).mean())}
    gates = {"vals": "logdet", "dets": "logdet", "logdet": "logdet", "g_inv": "g_inv",
             "curv": "curvature", "spectra": "spectra", "metric_slider": "logdet",
             "temporal_field": "logdet", "temporal_dets": "logdet", "det_field": "logdet",
             "det_path": "logdet", "g_full": "g", "riem": "dist2", "amp2": "dist2",
             "energy_path": "energy_path", "lengths": "length"}
    for module, e in errs.items():
        for field, err in e.items():
            if field in gates:
                check(err <= VIZ_TOL[gates[field]],
                      f"viz {module} {field}: card vs CPU {err} > {VIZ_TOL[gates[field]]}")
    for field in ("geodesic_frames", "generated"):
        check(errs["interactive"][field] <= GEN_ROW_TOL["max_abs"]
              and errs["interactive"][f"{field}_mean"] <= GEN_ROW_TOL["mean_abs"],
              f"viz interactive {field}: card vs CPU {errs['interactive']}")
    for name in out:
        out[name]["errors"] = errs[name]
    return out, total


def viz_hook_run(torch, card, x, cfg_map, run_dir):
    """The manager at FULL through the trainer's hook on the card, one epoch
    (0: every module due).  Where matplotlib is missing each module gives one
    ``viz/error`` naming it (interactive after its two sliders); where it
    imports, every artifact that tests/test_viz.py names is written."""
    from rlvae_tpu_torch.viz import make_viz_hook

    has_mpl = matplotlib_imports()
    log = _VizLog()
    hook = make_viz_hook(cfg_map, _VizData(x), run_dir, log)
    t = time.perf_counter()
    _, counts = counted(torch, lambda: hook(epoch=0, model=card, variables=None, trainer=None))
    host_s = time.perf_counter() - t
    errors = [r for r in log.records if "viz/error" in r]
    files = sorted(p.name for p in (Path(run_dir) / "visualizations" / "epoch_000").glob("*"))
    modules = ("BasicVisualizations", "ManifoldVisualizations", "FlowAnalysisVisualizations",
               "InteractiveVisualizations")
    if has_mpl:
        want = {"reconstructions.png", "cyclicity.png", "trajectories.png",
                "cyclicity_analysis.png", "reconstruction_analysis.png", "manifold_heatmap.png",
                "curvature.png", "temporal_metric.png", "enhanced_heatmaps.png",
                "temporal_metric_analysis.png", "sequence_slider.html", "geodesic_slider.html",
                "metric_slider.html", "temporal_animation.html", "latent_space_explorer.html",
                "latent_explorer.html", "fancy_geodesics.png", "flow_jacobians.png",
                "flow_det_evolution.png", "flow_animation.html"}
        check(not errors and want <= set(files), f"viz hook with matplotlib: {errors} {files}")
    else:
        check([e["viz/error"].split(" ")[0] for e in errors] == list(modules)
              and all("matplotlib" in e["viz/error"] for e in errors),
              f"viz hook without matplotlib: {errors}")
        check(files == ["geodesic_slider.html", "sequence_slider.html"],
              f"viz hook without matplotlib wrote {files}")
        # interactive's shared forward: the chol-bundle twice, the IAF chain once
        check(counts == expected_launches(chol_bundle=2, iaf_chain_fwd=1),
              f"viz hook without matplotlib launched {counts}")
    return {"matplotlib": has_mpl, "host_s": host_s, "launches": counts, "files": files,
            "errors": [e["viz/error"] for e in errors]}


def zoo_checks(torch, dev):
    """MAF (both directions and the round trip), planar, radial and the flow
    BatchNorm (train and eval, and the inverse) on the card against the CPU
    at D=ZOO_DIM, B=ZOO_BATCH, on the same parameters and inputs."""
    from rlvae_tpu_torch.flows import batchnorm as fbn
    from rlvae_tpu_torch.flows import zoo

    rng = np.random.default_rng(21)
    x = rng.normal(size=(ZOO_BATCH, ZOO_DIM)).astype(np.float32)
    xs = {d: torch.tensor(x, device=d) for d in (dev, "cpu")}
    gen = torch.Generator().manual_seed(21)
    maf = zoo.init_maf(ZOO_DIM, generator=gen)
    planar = {k: v * 30.0 for k, v in zoo.init_planar(ZOO_DIM, gen).items()}
    radial = {**zoo.init_radial(ZOO_DIM, gen), "beta_raw": torch.tensor(1.5),
              "log_alpha": torch.tensor(-0.5)}
    bn_p = {"log_gamma": torch.tensor(rng.normal(size=ZOO_DIM) * 0.3, dtype=torch.float32),
            "beta": torch.tensor(rng.normal(size=ZOO_DIM), dtype=torch.float32)}
    bn_s = {"running_mean": torch.tensor(rng.normal(size=ZOO_DIM), dtype=torch.float32),
            "running_var": torch.tensor(rng.uniform(0.5, 2, size=ZOO_DIM), dtype=torch.float32)}

    def on(d, tree):
        return {k: v.to(d) for k, v in tree.items()}

    def outputs(d):
        m = copy.deepcopy(maf).to(d)
        with torch.no_grad():
            y, ld = zoo.maf_forward(m, xs[d])
            back, ld_i = zoo.maf_inverse(m, y)
            res = {"maf_y": y, "maf_logdet": ld, "maf_x": back, "maf_logdet_inv": ld_i,
                   "planar": zoo.planar_forward(on(d, planar), xs[d])[0],
                   "planar_logdet": zoo.planar_forward(on(d, planar), xs[d])[1],
                   "radial": zoo.radial_forward(on(d, radial), xs[d])[0],
                   "radial_logdet": zoo.radial_forward(on(d, radial), xs[d])[1]}
            for train in (True, False):
                y, ld, st = fbn.batchnorm_forward(on(d, bn_p), on(d, bn_s), xs[d], train=train)
                xb, ldb = fbn.batchnorm_inverse(on(d, bn_p), st, y, train=train)
                tag = "train" if train else "eval"
                res.update({f"bn_{tag}_y": y, f"bn_{tag}_logdet": ld, f"bn_{tag}_x": xb,
                            f"bn_{tag}_logdet_inv": ldb,
                            **{f"bn_{tag}_{k}": v for k, v in st.items()}})
        return {k: v.detach().cpu().numpy() for k, v in res.items()}

    t = time.perf_counter()
    got = outputs(dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    want = outputs("cpu")
    errs = {k: _field_err(got[k], want[k]) for k in want}
    for k, e in errs.items():
        check(e <= ZOO_TOL, f"zoo {k}: card vs CPU {e}")
    roundtrip = _field_err(got["maf_x"], x)
    check(roundtrip <= ZOO_TOL, f"MAF round trip on the card: {roundtrip}")
    return {"host_s": card_s, "errors": errs, "maf_roundtrip": roundtrip, "tolerance": ZOO_TOL}


def pixelcnn_checks(torch, dev):
    """PixelCNN at the reference defaults: the loss and logits at
    B=PCNN_LOSS_BATCH against the CPU, then ``pixelcnn_sample`` of
    PCNN_SAMPLES images on the card (784 steps) from passed Gumbel noise; at
    PCNN_CHECK_STEPS the CPU recomputes the logits from the card's partial
    image, and the card's choice must be the CPU's argmax unless the CPU's
    two best scores lie within PCNN_TIE (counted)."""
    from rlvae_tpu_torch.flows.pixelcnn import PixelCNN, gumbel, pixelcnn_sample

    cpu = PixelCNN(seed=3)
    rng = np.random.default_rng(3)
    for norm in cpu.norms:  # running statistics away from the init's (0, 1)
        norm.mean.copy_(torch.tensor(rng.normal(size=norm.mean.shape) * 10, dtype=torch.float32))
        norm.var.copy_(torch.tensor(rng.uniform(50, 200, size=norm.var.shape),
                                    dtype=torch.float32))
    card = copy.deepcopy(cpu).to(dev)
    x = torch.tensor(rng.integers(0, 256, size=(PCNN_LOSS_BATCH, 1, 28, 28)), dtype=torch.int32)
    with torch.no_grad():
        out_c, out_p = card(x.to(dev)), cpu(x)
    logits_err = _of_largest(out_c.out.cpu().numpy(), out_p.out.numpy())
    loss_rel = abs(float(out_c.loss) - float(out_p.loss)) / abs(float(out_p.loss))
    check(logits_err <= PCNN_TOL and loss_rel <= PCNN_TOL,
          f"PixelCNN forward: logits {logits_err}, loss {loss_rel}")

    steps = 28 * 28
    noise = gumbel((steps, PCNN_SAMPLES, 256), torch.Generator().manual_seed(4))
    torch.cuda.synchronize()
    t = time.perf_counter()
    sample = pixelcnn_sample(card, PCNN_SAMPLES, noise=noise.to(dev))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t
    check(sample.shape == (PCNN_SAMPLES, 1, 28, 28) and int(sample.min()) >= 0
          and int(sample.max()) < 256, "bad PixelCNN samples")
    img = sample.cpu()
    ties, step_errs = 0, []
    for idx in PCNN_CHECK_STEPS:
        i, j = divmod(idx, 28)
        partial = img.clone().reshape(PCNN_SAMPLES, -1)
        partial[:, idx:] = 0  # the image as it stood at step idx
        partial = partial.reshape(img.shape)
        with torch.no_grad():
            lc = card(partial.to(dev)).out[:, :, 0, i, j].cpu()
            lp = cpu(partial).out[:, :, 0, i, j]
        step_errs.append(_of_largest(lc.numpy(), lp.numpy()))
        scores = (lp + noise[idx]).numpy()
        chosen = img[:, 0, i, j].numpy()
        top2 = np.sort(scores, -1)[:, -2:]
        gap = scores.max(-1) - scores[np.arange(PCNN_SAMPLES), chosen]
        tie = top2[:, 1] - top2[:, 0] <= PCNN_TIE
        check(bool(np.all((gap == 0) | tie)), f"PixelCNN step {idx}: the card chose {chosen}, "
                                               f"the CPU's scores {gap}")
        ties += int(np.sum(tie))
    check(max(step_errs) <= PCNN_TOL, f"PixelCNN step logits: card vs CPU {step_errs}")
    return {"loss": float(out_c.loss), "loss_rel": loss_rel, "logits_err": logits_err,
            "sample_host_s": sample_s, "steps": steps, "step_logits_err": step_errs,
            "ties": ties, "tolerance": {"logits": PCNN_TOL, "tie": PCNN_TIE}}


def slope_timer_checks(torch, metric, chol_device_ms=None):
    """B1 at the model's K=50 and B=64 through ``scan_slope_time`` (a CUDA
    graph over SLOPE_STACK distinct batches) and ``fori_slope_time`` (one
    captured launch replayed); structure gated, times reported."""
    from rlvae_tpu_torch.ops.metric_kernels import chol_bundle
    from rlvae_tpu_torch.utils.profiling import fori_slope_time, scan_slope_time

    c, m = metric.centroids, metric.matrices
    inv_t2, lbd = 1.0 / metric.temperature ** 2, metric.regularization + 1e-6
    g = torch.Generator(device=c.device).manual_seed(5)
    stack = c[torch.randint(0, c.shape[0], (SLOPE_STACK, SERVE_BATCH), generator=g,
                            device=c.device)]
    stack = stack + 0.05 * torch.randn(stack.shape, generator=g, device=c.device)
    keys = {"t_small_s", "t_big_s", "dispatch_overhead_s"}
    scan_s, scan_diag = scan_slope_time(lambda z: chol_bundle(z, c, m, inv_t2, lbd), stack,
                                        m_small=8, reps=5)
    fori_s, fori_diag = fori_slope_time(
        lambda i, z: z + 1e-7 * chol_bundle(z, c, m, inv_t2, lbd)[1][:, None], stack[0].clone(),
        n_small=8, n_big=SLOPE_STACK, reps=5)
    check(scan_s > 0 and fori_s > 0, f"slope timers: {scan_s}, {fori_s}")
    check(keys | {"m_small", "m_big"} <= set(scan_diag)
          and keys | {"n_small", "n_big"} <= set(fori_diag), "slope timer diagnostics")
    try:
        scan_slope_time(lambda z: z, stack[:4], m_small=8)
        short_stack_raises = False
    except ValueError:
        short_stack_raises = True
    check(short_stack_raises, "scan_slope_time took a stack of 4 at m_small=8")
    return {"scan_ms": scan_s * 1e3, "fori_ms": fori_s * 1e3, "scan": scan_diag,
            "fori": fori_diag, "kernels_phase_device_ms": chol_device_ms}


def run_viz(torch, dev=None, chol_device_ms=None):
    """The visualization modules, the flow zoo and the slope timers (section
    21 of the module docstring)."""
    from rlvae_tpu_torch import ModelManager, PRESETS
    from rlvae_tpu_torch.config import load_yaml
    from rlvae_tpu_torch.data import generate_cyclic_sequences
    from rlvae_tpu_torch.viz import VisualizationConfig
    from rlvae_tpu_torch.viz.base import SharedForward
    from rlvae_tpu_torch.viz.basic import BasicVisualizations

    cfg_map = load_yaml(VIZ_CONFIG.read_text())
    cfg = VisualizationConfig.from_mapping(cfg_map)
    check(cfg.max_sequences == VIZ_SEQS and not cfg.disable_curvature
          and cfg.enable_fancy_plots, f"{VIZ_CONFIG} is not the full level")
    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    cpu = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0, device="cpu")
    card_model, dev = manager.model, manager.device
    x = generate_cyclic_sequences(VIZ_SEQS, seed=31)
    out, total = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_viz_") as tmp:
        t = time.perf_counter()
        fwd, counts = counted(torch, lambda: SharedForward()(card_model, x, 0))
        out["forward"] = {"host_s": time.perf_counter() - t, "launches": counts}
        add_counts(total, counts)
        z = fwd.z.float().cpu().numpy()
        check(z.shape == (VIZ_SEQS, 8, 16) and np.isfinite(z).all(), "bad viz latents")
        t = time.perf_counter()  # basic: host statistics of the forward's outputs
        basic = BasicVisualizations(cfg, Path(tmp), None).fields(
            x, fwd.recon_x.float().cpu().numpy(), z)
        check(all(np.isfinite(v).all() for v in basic.values()), "basic fields not finite")
        out["basic"] = {"host_s": time.perf_counter() - t, "launches": expected_launches()}
        modules, counts = viz_module_fields(torch, card_model, cpu.model, z, cfg, Path(tmp))
        out["modules"] = modules
        add_counts(total, counts)
        out["hook"] = viz_hook_run(torch, card_model, x, cfg_map, Path(tmp) / "run")
        add_counts(total, out["hook"]["launches"])
    for name in ("chol_bundle", "iaf_chain_fwd", "metric_bundle", "g_inv"):
        check(total.get(name, 0) > 0, f"the viz path launched no {name}")
    out["launches"] = {**expected_launches(), **total}
    out["zoo"] = zoo_checks(torch, dev)
    t = time.perf_counter()
    out["pixelcnn"] = pixelcnn_checks(torch, dev)
    out["pixelcnn"]["host_s"] = time.perf_counter() - t
    out["slope_timers"] = slope_timer_checks(torch, card_model.metric, chol_device_ms)
    out["tolerance"] = {"fields": VIZ_TOL, "frames": GEN_ROW_TOL}
    return out


# ---------------------------------------------------------------------------
# research phase
# ---------------------------------------------------------------------------

RESEARCH_BATCH = TRAIN_BATCH
RESEARCH_GEN = 16  # rows of each model's generate
# per step: (epoch, visit): a warmup step (the per-frame objective), then the
# visit branch at the first visit and a later one: RIEM's last (its boundary
# prior carries the metric's volume), the flow models' fourth (from the last,
# seven density-direction IAFs at the reference init take |z| past fp32's
# range, in JAX as here)
RESEARCH_STEPS = ((0, None), (100, 0), (100, "later"))
RESEARCH_LATER_VISIT = {"riem": 7, "lvae_iaf": 3, "gugus_lvaegg": 3}
RESEARCH_FRAMES = 8
# the research CLI on the card, once per ported model: sprites frames
# (3x64x64) at the published widths, 2 epochs (a warmup epoch, then the
# visit branch) of 2 steps at B=16, missing visits and pixels, the MSE and a
# 4-sample NLL on 8 sequences.  Cut: 4 visits (from the last of 8 the
# reference-init flows take |z| past fp32's range, in JAX too), 32 sequences.
RESEARCH_CLI_MODELS = ("lvae_iaf", "vamp", "gpvae", "riem", "gugus", "lldm")
RESEARCH_CLI_ARGS = ["--dataset", "sprites", "--n_obs", "4", "--n_train", "32", "--n_eval", "8",
                     "--batch_size", "16", "--num_epochs", "2", "--warmup", "1",
                     "--compute_nll", "1", "--nll_n_samples", "4", "--prob_missing_data",
                     "0.25", "--prob_missing_pixels", "0.1", "--seed", "5"]
RESEARCH_TOL = {"loss_rel": 1e-3, "grad_norm_rel": 2e-2}  # as TRAIN_TOL: bf16 nets
GUGUS_HMC_LAUNCHES = 1 + 20 * (15 + 1)  # generate_hmc: 20 MCMC steps of 15 leapfrogs
GEN_MIN_MATCHING_ROWS = RESEARCH_GEN - 1  # an HMC accept decision may flip on a near-tie
# LLDM: the eps-net's pre-training (steps, batch), the sampled metric's
# centroids, the steps (epoch, visit): the warmup branch, the first visit,
# the last (against the metric's volume), the oversampled timeline's extra
# steps, and generate's HMC (MCMC steps, leapfrogs: JAX's defaults)
LLDM_PRETRAIN = (20, 128)
LLDM_CENTROIDS = 16
LLDM_STEPS = ((0, None), (100, 0), (100, 7))
LLDM_SUPP_STEPS = 4
LLDM_HMC = (100, 10)
# Adam's lr for LLDM's steps.  At the research phase's 1e-3 the first
# (warmup) step moves the encoder's log-variance head by several units, the
# latents grow by orders of magnitude, both boundary KLs sit at their clamp
# (500 and -2: the metric prior gives no gradient), and rounding-level
# changes of the frames move the next step's gradient norm by tens of
# percent on the CPU alone; at 1e-4 the KLs are live and the steps are well
# conditioned
LLDM_LR = 1e-4
# card vs CPU: the encoder's mu and log_var within 2^-8 of max(1, |z|)
# (the bf16 encoder's rounding, as FIXEDPOINT_E2E_TOL); latents the CPU
# computes from the card's encodings (the fp32 eps-net and DDIM bridge)
# within 1e-4 of max(1, |z|) (on an H100, 5.5e-7 to 9.1e-6); frames by their
# mean |d| and each pixel's |d|: the bf16 decoder's hidden layer rounds at
# other places on the two devices, and the DDIM bridge scales the latents
# it reads by up to sqrt(abar_end / abar_0) ~ 49 (on an H100, frames of
# latents equal to 1e-5 read 1e-8 to 5.8e-4 apart on average and up to
# 1.8e-2 in a pixel of generate's, latents to |z| ~ 80); the NLL (a mean
# of per-frame Gaussian log-likelihoods) relatively; the eps-net's first
# pre-training step (Adam's update is ~lr per weight) absolutely; an HMC
# step replayed from the card's state within 1e-4 of max(1, |z|), but at
# an accept tie
LLDM_TOL = {"z_encoder": 2 ** -8, "z": 1e-4, "frames_mean_abs": 2 ** -10,
            "frames_max_abs": 2 ** -5, "nll_rel": 1e-3, "pretrain_abs": 1e-4, "hmc_step": 1e-4}


def research_noise(torch, name, model, b, epoch, gen):
    """One training step's draws for the research model ``name`` (module
    docstrings of ``models/research``), on the CPU."""
    d = model.latent_dim
    if name == "gpvae":  # the posterior over each latent's trajectory
        return {"eps": torch.randn((b, d, model.time_length), generator=gen)}
    if name == "vamp":  # frames modelled independently
        return {"eps": torch.randn((b * RESEARCH_FRAMES, d), generator=gen)}
    rows = b * model.n_obs if epoch < model.warmup else b
    noise = {"eps": torch.randn((rows, d), generator=gen)}
    if name == "riem":
        noise["gamma"] = torch.randn((rows, d), generator=gen)
        if epoch >= model.warmup:
            noise["cand"] = 2.0 * torch.rand((b, 64, d), generator=gen) - 1.0
            noise["u"] = torch.rand((b, 64), generator=gen)
    return noise


def research_models(torch):
    """The research models at their published defaults (3x64x64, latent 16,
    8 visits, MLP nets 12288->512->16; LVAE_IAF's flows of hidden 128; RIEM
    on the K=50 metric at T=3.0; LVAE_GUGUS ``lvaegg`` with its Riemannian
    prior on; VAMP's 50 pseudo-inputs; GPVAE's Cauchy prior over 8 visits,
    its encoder 12288->512->48), seeded."""
    from rlvae_tpu_torch.geometry import load_metric
    from rlvae_tpu_torch.models.research import GPVAE, LVAE_GUGUS, LVAE_IAF, RIEM, VAMP

    metric = load_metric(PRETRAINED / "metric_T0.7_scaled.npz", temperature_override=3.0)
    return {"lvae_iaf": LVAE_IAF(seed=0), "riem": RIEM(metric=metric, seed=0),
            "gugus_lvaegg": LVAE_GUGUS(variant="lvaegg", use_riemann_prior=True, seed=0),
            "vamp": VAMP(seed=0), "gpvae": GPVAE(time_length=RESEARCH_FRAMES, seed=0)}


def hmc_k1_check(torch, metric, dev):
    """B4 at K=1 (GUGUS's one-centroid metric) against its plain version and
    fp64 at the generate batch, timed: outside the counted runs."""
    from rlvae_tpu_torch.ops.metric_kernels import hmc_terms, hmc_terms_ref
    from rlvae_tpu_torch.samplers.hmc import LOG_EPS

    b = RESEARCH_GEN
    z = (metric.centroids + torch.tensor(np.random.default_rng(9).normal(size=(b, 16)),
                                         dtype=torch.float32, device=dev)).contiguous()
    args = (metric.centroids, metric.matrices, 1.0 / metric.temperature ** 2,
            metric.regularization, LOG_EPS)
    got, want = hmc_terms(z, *args), hmc_terms_ref(z, *args)
    want64 = hmc_terms_ref(z.double(), *(a.double() if torch.is_tensor(a) else a for a in args))
    err = _terms_err(got, want)
    err64, err64_p = _terms_err(got, want64), _terms_err(want, want64)
    ok = err[1] and err64[0]["grad_rel"] <= max(IAF_FP64_FACTOR * err64_p[0]["grad_rel"], HMC_RTOL)
    check(ok, f"hmc_terms at K=1 disagrees: {err[0]}, vs fp64 {err64[0]} (plain {err64_p[0]})")
    bms, by = bound_ms(nbytes(z, metric.centroids, metric.matrices, *got), hmc_flops(b, 1))
    return with_device_ms(torch, {
        "shape": f"B={b},K=1,D=16", "vs_plain": err[0], "vs_fp64": err64[0],
        "plain_vs_fp64": err64_p[0], "ms": time_ms(torch, lambda: hmc_terms(z, *args), 20),
        "plain_ms": time_ms(torch, lambda: hmc_terms_ref(z, *args), 5),
        "bound_ms": bms, "bound_by": by}, lambda: hmc_terms(z, *args))


def _research_step(torch, model, opt, x, noise, vi, epoch):
    """One Adam step: the model's loss terms (each output named ``*loss``:
    GPVAE keeps the reference fork's names) and the gradient norm."""
    opt.zero_grad(set_to_none=True)
    out = model(x, noise=noise, vi_index=vi, epoch=epoch, train=True)
    out.loss.backward()
    metrics = {k: float(v.detach()) for k, v in out.items() if k.endswith("loss")}
    metrics["grad_norm"] = _grad_norm(torch, model)
    opt.step()
    return metrics


def research_cli_runs(torch, dev):
    """``python -m rlvae_tpu_torch.research_cli`` in-process, once per ported
    model, on ``dev``: RESEARCH_CLI_ARGS in a temporary output directory,
    the result line read from its standard output.  Its models launch no
    kernel of the port (RIEM runs there without a metric, as in JAX)."""
    import io

    from rlvae_tpu_torch import research_cli

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_research_cli_") as tmp:
        for model in RESEARCH_CLI_MODELS:
            buf, before = io.StringIO(), launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = research_cli.main(["--model", model, "--device", dev.type,
                                        *RESEARCH_CLI_ARGS, "--output_dir", tmp])
            torch.cuda.synchronize()
            result = json.loads(buf.getvalue().strip().splitlines()[-1])
            values = [result[k] for k in ("final_loss", "eval_mse", "eval_nll") if k in result]
            check(rc == 0 and result["model"] == model and all(np.isfinite(values)),
                  f"research_cli --model {model}: rc {rc}, {result}")
            runs[model] = {**result, "host_s": time.perf_counter() - t0,
                           "launches": {k: v - before[k] for k, v in launch_counts().items()
                                        if v - before[k]}}
    return runs


def run_research(torch, dev=None):
    """LVAE_IAF, RIEM, LVAE_GUGUS (``lvaegg``), VAMP and GPVAE on the card at
    their published widths: each takes the RESEARCH_STEPS Adam steps at B=16
    (each step replayed on the CPU from the card's weights and Adam state
    before it, on the same draws: losses and grad norm), then generates 16
    sequences (against the CPU on the same draws; VAMP's frames through
    ``VampSampler``).  GUGUS first estimates
    its local metrics on the card, and generates by manifold HMC on its
    one-centroid metric (B4 at K=1: 321 launches); its ``lvaega`` training
    draw, which autograd would differentiate through B4, raises.  The
    counters are zeroed just before and read just after each model's
    steps and generate; B4 at K=1 is held to its plain version and fp64
    apart from them.  Then the research CLI trains each of the five ported
    models (:func:`research_cli_runs`)."""
    from rlvae_tpu_torch.convert import gugus_host_state, set_gugus_host_state
    from rlvae_tpu_torch.models.research import LVAE_GUGUS

    dev = torch.device("cuda") if dev is None else dev
    rng = np.random.default_rng(10)
    seqs = rng.uniform(size=(RESEARCH_BATCH * len(RESEARCH_STEPS), 8, 3, 64, 64)).astype(np.float32)
    out, total = {}, {name: 0 for name in _wrappers()}
    for name, cpu_model in research_models(torch).items():
        model = copy.deepcopy(cpu_model).to(dev)
        rec = {}
        if name.startswith("gugus"):
            t0 = time.perf_counter()
            with torch.no_grad():
                model.retrieve_metric_local(torch.from_numpy(seqs).to(dev))
            rec["retrieve_metric_local_s"] = time.perf_counter() - t0
            set_gugus_host_state(cpu_model, gugus_host_state(model))
            rec["temperature"] = model.sampled_metric.temperature
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        cpu_opt = torch.optim.Adam(cpu_model.parameters(), lr=1e-3)
        gen = torch.Generator().manual_seed(11)
        steps, errors = [], []
        torch.cuda.synchronize()
        zero_launch_counts()
        for i, (epoch, vi) in enumerate(RESEARCH_STEPS):
            # (VAMP and GPVAE take no visit)
            vi = RESEARCH_LATER_VISIT.get(name, 0) if vi == "later" else (vi or 0)
            x = torch.from_numpy(seqs[i * RESEARCH_BATCH:(i + 1) * RESEARCH_BATCH])
            noise = research_noise(torch, name, model, RESEARCH_BATCH, epoch, gen)
            state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            opt_state = copy.deepcopy(opt.state_dict())
            before = launch_counts()
            t0 = time.perf_counter()
            m = _research_step(torch, model, opt, x.to(dev),
                               {k: v.to(dev) for k, v in noise.items()}, vi, epoch)
            torch.cuda.synchronize()
            m["host_ms"] = (time.perf_counter() - t0) * 1e3
            m["launches"] = {k: v - before[k] for k, v in launch_counts().items() if v - before[k]}
            check(all(np.isfinite(v) for v in (m["loss"], m["grad_norm"])),
                  f"{name} step {i + 1} not finite")
            steps.append(m)
            cpu_model.load_state_dict(state)
            cpu_opt.load_state_dict(opt_state)
            c = _research_step(torch, cpu_model, cpu_opt, x, noise, vi, epoch)
            err = {k: abs(m[k] - c[k]) / max(abs(c[k]), 1e-12) for k in c}
            errors.append(err)
            for k in (k for k in c if k != "grad_norm"):
                check(err[k] <= RESEARCH_TOL["loss_rel"] or abs(m[k] - c[k]) <= 1e-5,
                      f"{name} step {i + 1} {k}: card vs CPU {err[k]}")
            check(err["grad_norm"] <= RESEARCH_TOL["grad_norm_rel"],
                  f"{name} step {i + 1} grad_norm: card vs CPU {err['grad_norm']}")
        cpu_model.load_state_dict({k: v.detach().cpu() for k, v in model.state_dict().items()})
        with torch.no_grad():
            if name.startswith("gugus"):
                noise = {"gammas": torch.randn((20, RESEARCH_GEN, 16), generator=gen),
                         "unifs": torch.rand((20, RESEARCH_GEN), generator=gen)}
                before = launch_counts()["hmc_terms"]
                t0 = time.perf_counter()
                got = model.generate_hmc(RESEARCH_GEN, noise={k: v.to(dev) for k, v in noise.items()})
                torch.cuda.synchronize()
                rec["generate_hmc_s"] = time.perf_counter() - t0
                rec["generate_hmc_launches"] = launch_counts()["hmc_terms"] - before
                check(rec["generate_hmc_launches"] == GUGUS_HMC_LAUNCHES,
                      f"generate_hmc launched hmc_terms {rec['generate_hmc_launches']} times")
                want = cpu_model.generate_hmc(RESEARCH_GEN, noise=noise)
            elif name == "vamp":  # through the sampler: a component, then its Gaussian
                from rlvae_tpu_torch.samplers import VampSampler

                noise = {"idx": torch.randint(0, model.number_components, (RESEARCH_GEN,),
                                              generator=gen),
                         "eps": torch.randn((RESEARCH_GEN, 16), generator=gen)}
                card, cpu = VampSampler(model), VampSampler(cpu_model)
                got = torch.from_numpy(card._decode(card.sample_latents(
                    RESEARCH_GEN, noise={k: v.to(dev) for k, v in noise.items()})))
                want = torch.from_numpy(cpu._decode(cpu.sample_latents(RESEARCH_GEN, noise=noise)))
            elif name == "gpvae":
                noise = {"eps": torch.randn((RESEARCH_GEN, 16, RESEARCH_FRAMES), generator=gen)}
                got = model.generate(RESEARCH_GEN, noise={k: v.to(dev) for k, v in noise.items()})
                want = cpu_model.generate(RESEARCH_GEN, noise=noise)
            else:
                noise = {"z": torch.randn((RESEARCH_GEN, 16), generator=gen),
                         "gamma": torch.randn((RESEARCH_GEN, 16), generator=gen)}
                got = model.generate(RESEARCH_GEN, noise={k: v.to(dev) for k, v in noise.items()})
                want = cpu_model.generate(RESEARCH_GEN, noise=noise)
        torch.cuda.synchronize()
        rec["launches"] = launch_counts()
        got = got.float().cpu()
        shape = (RESEARCH_GEN, 3, 64, 64) if name == "vamp" else (RESEARCH_GEN, 8, 3, 64, 64)
        check(tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
              f"bad {name} generate output")
        row_err = (got - want.float()).abs().flatten(1)
        rows_ok = int(((row_err.mean(1) <= GEN_ROW_TOL["mean_abs"])
                       & (row_err.amax(1) <= GEN_ROW_TOL["max_abs"])).sum())
        check(rows_ok >= (GEN_MIN_MATCHING_ROWS if name.startswith("gugus") else RESEARCH_GEN),
              f"{name} generate: {rows_ok} of {RESEARCH_GEN} rows match the CPU")
        rec.update({"steps": steps, "card_vs_cpu": {"errors": errors, "tolerances": RESEARCH_TOL},
                    "generate": {"rows": RESEARCH_GEN, "rows_matching_cpu": rows_ok,
                                 "mean_abs": float(row_err.mean()),
                                 "tolerance": GEN_ROW_TOL}})
        for k, v in rec["launches"].items():
            total[k] += v
        if name.startswith("gugus"):
            rec["hmc_terms_k1"] = hmc_k1_check(torch, model.hmc_metric(0), dev)
            lvaega = LVAE_GUGUS(variant="lvaega", use_riemann_prior=True, seed=0).to(dev)
            lvaega.load_state_dict(model.state_dict())
            set_gugus_host_state(lvaega, gugus_host_state(model))
            try:
                lvaega(torch.from_numpy(seqs[:RESEARCH_BATCH]).to(dev), vi_index=0, epoch=100,
                       train=True, generator=gen)
                raised = False
            except NotImplementedError:
                raised = True
            # on the CPU the plain terms are differentiable, as JAX's XLA terms are
            check(raised == (dev.type == "cuda"),
                  f"lvaega's HMC training draw on {dev.type}: raised={raised}")
            rec["lvaega_train_draw_raises"] = raised
        out[name] = rec
    check(total["chol_bundle"] > 0 and total["metric_bundle"] > 0 and total["hmc_terms"] > 0,
          f"the research path did not launch B1, B6 and B4: {total}")
    check(total["iaf_chain_fwd"] == 0 and total["iaf_chain_bwd"] == 0,
          f"the research models' flows launched the IAF chain: {total}")
    out["launches"] = total
    out["lldm"] = run_lldm(torch, dev)
    out["cli"] = research_cli_runs(torch, dev)
    return out


def _lldm_close(torch, got, want, what, z_tol=LLDM_TOL["z"]):
    """Latents [..., D] within ``z_tol`` of max(1, |z|), or frames within
    LLDM_TOL's mean and per-pixel |d|; returns the errors."""
    got, want = got.detach().float().cpu(), want.detach().float()
    check(bool(torch.isfinite(got).all()), f"LLDM {what}: non-finite on the card")
    if what.startswith("z"):
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        check(err <= z_tol, f"LLDM {what}: card vs CPU {err}")
        return {"max_scaled": err}
    diff = (got - want).abs()
    err = {"mean_abs": float(diff.mean()), "max_abs": float(diff.max())}
    check(err["mean_abs"] <= LLDM_TOL["frames_mean_abs"]
          and err["max_abs"] <= LLDM_TOL["frames_max_abs"], f"LLDM {what}: card vs CPU {err}")
    return err


@contextlib.contextmanager
def _encoding_of(model, enc):
    """Inside, ``model`` encodes every batch of frames as ``enc``, a
    (mu, log_var, context) triple: the card's, for a CPU replay."""
    model._encode = lambda frames: enc
    try:
        yield
    finally:
        del model._encode


@contextlib.contextmanager
def _hmc_traced(trace):
    """Inside, LLDM's HMC chains append every MCMC step to ``trace``."""
    from rlvae_tpu_torch.models.research import lldm

    plain = lldm.hmc_sampling
    lldm.hmc_sampling = lambda *a, **k: plain(*a, **k, trace=trace)
    try:
        yield
    finally:
        lldm.hmc_sampling = plain


LLDM_TIE_MARGIN = 1e-3  # |u - alpha| of an accept that rounding may flip (ROADMAP C3)


def _lldm_chain_replay(torch, metric, mu, noise, trace):
    """Each MCMC step of the card's HMC chain (``trace``) replayed on the CPU
    from the card's state before it, on the same draws: a row may leave the
    card's step beyond LLDM_TOL["hmc_step"] of max(1, |z|) only at an
    accept tie."""
    from rlvae_tpu_torch.models.research.lldm import hmc_sampling

    z = mu[noise["idx"]]
    n = z.shape[0]
    worst, ties, off = 0.0, 0, 0
    for s, (u, alpha, acc, z_card) in enumerate(trace):
        step = []
        got, _ = hmc_sampling(metric, z, n, 1, noise={"idx": torch.arange(n),
                                                      "rho": noise["rho"][s:s + 1],
                                                      "u": noise["u"][s:s + 1]}, trace=step)
        err = ((got - z_card).abs() / z_card.abs().clamp_min(1.0)).amax(1)
        tie = ((u - alpha).abs() < LLDM_TIE_MARGIN) | ((u - step[0][1]).abs() < LLDM_TIE_MARGIN)
        ties += int(tie.sum())
        off += int((err > LLDM_TOL["hmc_step"]).sum())
        check(not bool(((err > LLDM_TOL["hmc_step"]) & ~tie).any()),
              f"LLDM HMC step {s + 1}: rows off the CPU's replay without a tie: {err.tolist()}")
        worst = max(worst, float(err[~tie].max()) if bool((~tie).any()) else 0.0)
        z = z_card
    accepted = sum(int(acc.sum()) for _, _, acc, _ in trace)
    check(0 < accepted, "the LLDM chain accepted no proposal")
    return {"replayed_steps": len(trace), "max_scaled_step_err": worst, "tie_rows": ties,
            "rows_off_at_ties": off, "accept_rate": accepted / (n * len(trace))}


def run_lldm(torch, dev=None):
    """LLDM at JAX's defaults with the posterior IAF, on ``dev``, each piece
    against the CPU on the same draws (module docstring, phase 18).  The
    launch counters are zeroed before and read after; LLDM launches none."""
    from rlvae_tpu_torch.models.research import LLDM, pretrain_latent_diffusion

    dev = torch.device("cuda") if dev is None else dev
    rng = np.random.default_rng(12)
    b, n_obs = RESEARCH_BATCH, 8
    seqs = rng.uniform(size=(b * len(LLDM_STEPS), n_obs, 3, 64, 64)).astype(np.float32)
    cpu_model = LLDM(posterior="iaf", seed=0)
    model = copy.deepcopy(cpu_model).to(dev)
    d, gen = model.latent_dim, torch.Generator().manual_seed(13)
    rec, on_dev = {}, (lambda nz: {k: (v.to(dev) if torch.is_tensor(v) else [a.to(dev) for a in v])
                                   for k, v in nz.items()})
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()

    # the eps-net, pre-trained on the card's encodings; its first step replayed
    steps, bs = LLDM_PRETRAIN
    with torch.no_grad():
        latents = model._encode(torch.from_numpy(seqs.reshape(-1, 3, 64, 64)).to(dev))[0].float()
    noise = {"idx": torch.randint(0, latents.shape[0], (steps, bs), generator=gen),
             "t": torch.randint(0, model.ldm.n_train_steps, (steps, bs), generator=gen),
             "eps": torch.randn((steps, bs, d), generator=gen)}
    first = {k: v[:1] for k, v in noise.items()}
    one = pretrain_latent_diffusion(latents, n_steps=1, batch_size=bs,
                                    ldm=copy.deepcopy(cpu_model.ldm), noise=on_dev(first))
    one_cpu = pretrain_latent_diffusion(latents.cpu(), n_steps=1, batch_size=bs,
                                        ldm=copy.deepcopy(cpu_model.ldm), noise=first)
    err = max(float((v.cpu() - one_cpu.state_dict()[k]).abs().max())
              for k, v in one.state_dict().items())
    check(err <= LLDM_TOL["pretrain_abs"], f"LLDM pre-training step 1: card vs CPU {err}")
    t = time.perf_counter()
    trained = pretrain_latent_diffusion(latents, n_steps=steps, batch_size=bs,
                                        ldm=copy.deepcopy(cpu_model.ldm), noise=on_dev(noise))
    torch.cuda.synchronize()
    rec["pretrain"] = {"steps": steps, "batch": bs, "latents": list(latents.shape),
                       "host_s": time.perf_counter() - t, "step1_max_abs_vs_cpu": err}
    model.ldm.load_state_dict(trained.state_dict())
    cpu_model.ldm.load_state_dict({k: v.cpu() for k, v in trained.state_dict().items()})

    # the sampled metric of the data end's encodings (numpy on the host:
    # the CPU model shares it, so its prior is built from the card's mu)
    with torch.no_grad():
        metric, _, _ = model.retrieve_g(torch.from_numpy(seqs[:, -1]).to(dev), LLDM_CENTROIDS)
    model.pretrained_metric = cpu_model.pretrained_metric = metric
    rec["metric"] = {"centroids": int(metric.centroids.shape[0]),
                     "temperature": metric.temperature}

    # Adam steps, each replayed on the CPU from the card's state before it
    opt = torch.optim.Adam(model.parameters(), lr=LLDM_LR)
    cpu_opt = torch.optim.Adam(cpu_model.parameters(), lr=LLDM_LR)
    rec["steps"], rec["errors"] = [], []
    for i, (epoch, vi) in enumerate(LLDM_STEPS):
        x = torch.from_numpy(seqs[i * b:(i + 1) * b])
        noise = ({"eps": torch.randn((b * n_obs, d), generator=gen)} if epoch < model.warmup
                 else {"eps": torch.randn((b, d), generator=gen),
                       "bridge": torch.randn((n_obs - 1, b, d), generator=gen)})
        state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        opt_state = copy.deepcopy(opt.state_dict())
        t = time.perf_counter()
        m = _research_step(torch, model, opt, x.to(dev), on_dev(noise), vi or 0, epoch)
        torch.cuda.synchronize()
        m["host_ms"] = (time.perf_counter() - t) * 1e3
        check(all(np.isfinite(v) for v in (m["loss"], m["grad_norm"])),
              f"LLDM step {i + 1} not finite")
        cpu_model.load_state_dict(state)
        cpu_opt.load_state_dict(opt_state)
        c = _research_step(torch, cpu_model, cpu_opt, x, noise, vi or 0, epoch)
        err = {k: abs(m[k] - c[k]) / max(abs(c[k]), 1e-12) for k in c}
        for k in (k for k in c if k != "grad_norm"):
            check(err[k] <= RESEARCH_TOL["loss_rel"] or abs(m[k] - c[k]) <= 1e-5,
                  f"LLDM step {i + 1} {k}: card vs CPU {err[k]}")
        check(err["grad_norm"] <= RESEARCH_TOL["grad_norm_rel"],
              f"LLDM step {i + 1} grad_norm: card vs CPU {err['grad_norm']}")
        rec["steps"].append({"epoch": epoch, "visit": vi, **m})
        rec["errors"].append(err)
    cpu_model.load_state_dict({k: v.detach().cpu() for k, v in model.state_dict().items()})

    # inference, card against the CPU on the same draws; the CPU replays
    # from the card's encodings (held to the CPU's apart), as the DDIM
    # bridge scales a latent's rounding by up to sqrt(abar_end / abar_i)
    x, vi, p_vi, n_pred = torch.from_numpy(seqs[:b]), 3, 2, 4
    inference = {}
    with torch.no_grad():
        encodings = {}
        for key, frames in (("visit", x[:, vi]), ("predict", x[:n_pred, p_vi])):
            card_enc = model._encode(frames.to(dev))
            cpu_enc = cpu_model._encode(frames)
            inference[f"encoder_{key}"] = {
                k: _lldm_close(torch, a, c, f"z {k} {key}", LLDM_TOL["z_encoder"])
                for k, a, c in (("mu", card_enc[0], cpu_enc[0]), ("log_var", card_enc[1],
                                                                  cpu_enc[1]))}
            encodings[key] = (card_enc[0].cpu(), card_enc[1].cpu(), None)
        noise = {"eps": torch.randn((b, d), generator=gen),
                 "bridge": torch.randn((n_obs - 1, b, d), generator=gen)}
        got = model.reconstruct(x.to(dev), vi, noise=on_dev(noise))
        with _encoding_of(cpu_model, encodings["visit"]):
            want = cpu_model.reconstruct(x, vi, noise=noise)
        inference["reconstruct"] = {"z": _lldm_close(torch, got[0], want[0], "z reconstruct"),
                                    "recon": _lldm_close(torch, got[1], want[1], "reconstruct")}
        n_line = n_obs - 1 + LLDM_SUPP_STEPS
        noise["bridge"] = torch.randn((n_line - 1, b, d), generator=gen)
        got = model.oversample(x.to(dev), vi, num_supp_steps=LLDM_SUPP_STEPS, noise=on_dev(noise))
        with _encoding_of(cpu_model, encodings["visit"]):
            want = cpu_model.oversample(x, vi, num_supp_steps=LLDM_SUPP_STEPS, noise=noise)
        check(tuple(got[1].shape) == (b * n_line, 3, 64, 64), f"oversample {tuple(got[1].shape)}")
        inference["oversample"] = {"z": _lldm_close(torch, got[0], want[0], "z oversample"),
                                   "recon": _lldm_close(torch, got[1], want[1], "oversample")}
        noise = {"bridge": [torch.randn((n_obs - 1 - p_vi, n_pred * n_pred, d), generator=gen)]}
        got = model.predict(x[:n_pred].to(dev), p_vi, num_gen_seq=n_pred, noise=on_dev(noise))
        with _encoding_of(cpu_model, encodings["predict"]):
            want = cpu_model.predict(x[:n_pred], p_vi, num_gen_seq=n_pred, noise=noise)
        inference["predict"] = _lldm_close(torch, got.flatten(0, 1), want.flatten(0, 1),
                                           "predict")
        n_nll, samples = 2, 4
        noise = {"eps": torch.randn((n_nll, 1, samples, d), generator=gen),
                 "bridge": torch.randn((n_nll, 1, n_obs - 1, samples, d), generator=gen)}
        got = model.get_nll(x[:n_nll].to(dev), vi, n_samples=samples, noise=on_dev(noise))
        want = cpu_model.get_nll(x[:n_nll], vi, n_samples=samples, noise=noise)
        rel = abs(got - want) / abs(want)
        check(np.isfinite(got) and rel <= LLDM_TOL["nll_rel"], f"LLDM get_nll {got} vs {want}")
        inference["get_nll"] = {"card": got, "cpu": want, "rel": rel}

        # generate: HMC anchors on the first visit's metric, then the bridge;
        # the CPU's metric is built from the card's encodings of that visit
        mcmc, n_lf = LLDM_HMC
        noise = {"idx": torch.randint(0, seqs.shape[0], (RESEARCH_GEN,), generator=gen),
                 "rho": torch.randn((mcmc, RESEARCH_GEN, d), generator=gen),
                 "u": torch.rand((mcmc, RESEARCH_GEN), generator=gen),
                 "bridge": [torch.randn((n_obs - 1, RESEARCH_GEN, d), generator=gen)]}
        trace, all_seqs = [], torch.from_numpy(seqs).to(dev)
        t = time.perf_counter()
        with _hmc_traced(trace):
            frames, z_seq = model.generate(all_seqs, RESEARCH_GEN, mcmc_steps_nbr=mcmc,
                                           noise=on_dev(noise))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        card_enc = model._encode(all_seqs[:, 0])
        with _encoding_of(cpu_model, (card_enc[0].cpu(), card_enc[1].cpu(), None)):
            g_metric, mu, _ = cpu_model.retrieve_g(torch.from_numpy(seqs[:, 0]), t_multiplier=0.5)
        inference["generate"] = {"rows": RESEARCH_GEN, "mcmc_steps": mcmc, "n_lf": n_lf,
                                 "centroids": int(g_metric.centroids.shape[0]), "host_s": gen_s,
                                 **_lldm_chain_replay(torch, g_metric, mu, noise, trace)}
        # the bridge and decoder from the card's anchors
        frames = frames.float().cpu()
        check(tuple(frames.shape) == (RESEARCH_GEN, n_obs, 3, 64, 64)
              and bool(torch.isfinite(frames).all()), "bad LLDM generate output")
        want_z, want = cpu_model._decode_bridged(z_seq[:, 0].cpu(), 0, noise["bridge"][0])
        inference["generate"].update({
            "z_bridged": _lldm_close(torch, z_seq, want_z, "z generate"),
            "frames_bridged": _lldm_close(torch, frames, want.reshape(frames.shape), "generate"),
            "max_abs_z": float(z_seq.abs().max())})
    rec["launches"] = launch_counts()
    check(sum(rec["launches"].values()) == 0, f"LLDM launched kernels: {rec['launches']}")
    rec.update({"inference": inference, "tolerances": {
                    **LLDM_TOL, "steps": RESEARCH_TOL, "tie_margin": LLDM_TIE_MARGIN},
                "host_s": time.perf_counter() - t0})
    return rec


# ---------------------------------------------------------------------------
# latent_dims phase: every latent width the JAX package runs
# ---------------------------------------------------------------------------

# The widths of the kernel checks (1..16 run the kernels' width-16 instances,
# 17..32 the width-32 ones; all but 16 and 32 a zero-padded bank), the banks
# and batches at each, and the wide case; the metric kernels' temperature
# scales with D (inv_t2 = 4/D), so that many centroids weigh in at every width
LATENT_DIMS = (1, 2, 5, 8, 12, 16, 24, 31, 32)
LATENT_BANKS = (1, 50, 200)
LATENT_BATCHES = (1, SERVE_BATCH)
LATENT_WIDE_K = 20_000
BANK_KERNEL_NAMES = ("chol_bundle", "hmc_terms", "metric_bundle", "g_inv", "hmc_partials")
BANK_KERNEL_OUTPUTS = {"chol_bundle": ("l", "logdet"), "hmc_terms": ("log_pi", "grad"),
                       "metric_bundle": ("g_inv", "l", "logdet", "g"), "g_inv": ("g_inv",),
                       "hmc_partials": ("gi_part", "v")}
BANK_KERNEL_SOURCES = {
    "chol_bundle": ("rlvae_tpu_torch/csrc/chol_bundle.cu", "rlvae_tpu/ops/metric_kernels.py:470"),
    "hmc_terms": ("rlvae_tpu_torch/csrc/hmc_terms.cu", "rlvae_tpu/ops/metric_kernels.py:809"),
    "metric_bundle": ("rlvae_tpu_torch/csrc/metric_bundle.cu",
                      "rlvae_tpu/ops/metric_kernels.py:657"),
    "g_inv": ("rlvae_tpu_torch/csrc/metric_bundle.cu", "rlvae_tpu/ops/metric_kernels.py:618"),
    "hmc_partials": ("rlvae_tpu_torch/csrc/hmc_partials.cu",
                     "rlvae_tpu/ops/metric_kernels.py:886"),
}


def latent_bank(d: int, k: int, seed: int):
    """A seeded D-wide bank: K centroids ~ N(0, I) and SPD matrices a a^T / D + 0.1 I."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)).astype(np.float32)
    a = (rng.normal(size=(k, d, d)) / np.sqrt(d)).astype(np.float32)
    return c, (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)


def latent_rows(c: np.ndarray, b: int, seed: int) -> np.ndarray:
    """B rows near the bank's centroids; with B > 1 the last two far from all."""
    rng = np.random.default_rng(seed)
    z = c[rng.integers(0, c.shape[0], size=b)] + 0.05 * rng.normal(size=(b, c.shape[1]))
    if b > 1:
        z[-2:] += 100.0
    return z.astype(np.float32)


def bank_kernel_calls(name: str, d: int):
    """(kernel wrapper, plain version) of ``name`` on (z, c, m) at width ``d``'s
    scalars: inv_t2 = 4/D, lbd = 0.01 (B1: + the 1e-6 jitter)."""
    from rlvae_tpu_torch.ops import metric_kernels as mk

    inv_t2, lbd, log_eps = 4.0 / d, 0.01, float(np.log(np.float32(1e-10)))
    scalars = {"chol_bundle": (inv_t2, lbd + 1e-6), "hmc_terms": (inv_t2, lbd, log_eps),
               "metric_bundle": (inv_t2, lbd), "g_inv": (inv_t2, lbd),
               "hmc_partials": (inv_t2,)}[name]
    kernel, plain = getattr(mk, name), getattr(mk, f"{name}_ref")

    def tup(out):
        return out if isinstance(out, tuple) else (out,)

    return (lambda z, c, m: tup(kernel(z, c, m, *scalars)),
            lambda z, c, m: tup(plain(z, c, m, *scalars)))


def bank_kernel_errors(name: str, got, plain, want):
    """({output: errors}, ok) of the kernel's outputs against the plain fp32
    version's and an fp64 evaluation's, at the kernels phase's tolerances:
    B1 CHOL_RTOL/ATOL, B6/B7 BUNDLE_TOL (fp64: BUNDLE_FP64_FACTOR x the
    plain's, or BUNDLE_FP64_RTOL of scale; B1 the same), B4 log pi
    HMC_LP_ATOL and grad HMC_RTOL of its scale (fp64: IAF_FP64_FACTOR x, or
    HMC_RTOL of scale), B8 PARTIALS_TOL of max(1, |plain|) (fp64:
    IAF_FP64_FACTOR x, or PARTIALS_FP64_RTOL of scale)."""
    err, ok = {}, True
    for out, k_out, p_out, e_out in zip(BANK_KERNEL_OUTPUTS[name], got, plain, want):
        d_kp = (k_out - p_out).abs()
        ke = float((k_out.double() - e_out).abs().max())
        pe = float((p_out.double() - e_out).abs().max())
        scale = float(e_out.abs().max())
        if name == "chol_bundle":
            good = bool((d_kp <= CHOL_ATOL + CHOL_RTOL * p_out.abs()).all())
            good = good and ke <= max(BUNDLE_FP64_FACTOR * pe, BUNDLE_FP64_RTOL * scale)
        elif name in ("metric_bundle", "g_inv"):
            rtol, atol = BUNDLE_TOL[out]
            good = bool((d_kp <= atol + rtol * p_out.abs()).all())
            good = good and ke <= max(BUNDLE_FP64_FACTOR * pe, BUNDLE_FP64_RTOL * scale)
        elif name == "hmc_terms":
            good = (float(d_kp.max()) <= HMC_LP_ATOL if out == "log_pi"
                    else float(d_kp.max()) <= HMC_RTOL * max(float(p_out.abs().max()), 1e-30))
            good = good and ke <= max(IAF_FP64_FACTOR * pe, HMC_RTOL * scale)
        else:
            good = bool((d_kp <= PARTIALS_TOL[out] * p_out.abs().clamp_min(1.0)).all())
            good = good and ke <= max(IAF_FP64_FACTOR * pe, PARTIALS_FP64_RTOL * scale)
        err[out] = {"kernel_vs_plain_abs": float(d_kp.max()), "kernel_vs_fp64_abs": ke,
                    "plain_vs_fp64_abs": pe, "fp64_scale": scale, "ok": good}
        ok = ok and good
    return err, ok


def bank_kernel_structure(torch, name: str, got, lbd: float = 0.01) -> bool:
    """L zero above its diagonal, G bitwise symmetric, and the far rows (the
    last two of a batch) exact: G^{-1} = lbd I, a zero gradient, zero sums."""
    b, ok = got[0].shape[0], True
    if name in ("chol_bundle", "metric_bundle"):
        l = got[0] if name == "chol_bundle" else got[1]
        ok = ok and bool(torch.all(torch.triu(l, 1) == 0))
    if name == "metric_bundle":
        ok = ok and bool(torch.equal(got[3], got[3].transpose(-1, -2)))
    if b > 1:
        if name in ("metric_bundle", "g_inv"):
            d = got[0].shape[-1]
            eye = lbd * torch.eye(d, device=got[0].device)
            ok = ok and bool(torch.equal(got[0][-2:], eye.expand(2, d, d)))
        elif name == "hmc_terms":
            ok = ok and bool(torch.all(got[1][-2:] == 0))
        elif name == "hmc_partials":
            ok = ok and bool(torch.all(got[0][-2:] == 0) and torch.all(got[1][-2:] == 0))
    return ok


def bank_kernel_case(torch, dev, name: str, d: int, k: int, b: int, replay: bool = False):
    """One check of ``name`` at (D, K, B): against plain and fp64, the
    structure, bit-identical on relaunch and (``replay``) in a CUDA-graph
    replay."""
    c_np, m_np = latent_bank(d, k, 1000 * d + k)
    z_np = latent_rows(c_np, b, 7 * d + k + b)
    z, c, m = (torch.tensor(v, device=dev) for v in (z_np, c_np, m_np))
    kernel, plain = bank_kernel_calls(name, d)
    got, again = kernel(z, c, m), kernel(z, c, m)
    ref = plain(z, c, m)
    want = plain(z.double(), c.double(), m.double())
    torch.cuda.synchronize()
    err, ok = bank_kernel_errors(name, got, ref, want)
    structure = bank_kernel_structure(torch, name, got)
    relaunch = all(map(torch.equal, got, again))
    shapes = all(tuple(g.shape) == tuple(r.shape) for g, r in zip(got, ref))
    case = {"kernel": name, "d": d, "k": k, "b": b, "errors": err, "structure": structure,
            "relaunch_bit_identical": relaunch, "shapes": shapes,
            "max_abs_err": max(e["kernel_vs_plain_abs"] for e in err.values())}
    if replay:
        case["graph_replay_bit_identical"] = graph_replay_equal(torch, lambda: kernel(z, c, m),
                                                                got)
    case["ok"] = ok and structure and relaunch and shapes and case.get(
        "graph_replay_bit_identical", True)
    check(case["ok"], f"{name} at D={d}, K={k}, B={b}: {case}")
    return case, (z, c, m, got)


def bank_kernel_bound(name: str, b: int, k: int, d: int, tensors) -> tuple:
    """(bound ms, bound by) of ``name`` at (B, K, D): the bytes of its inputs
    and outputs, and its FLOP at fp32."""
    flops = {"chol_bundle": bundle_flops(b, k, False, d) + b * (d ** 3 / 3 + d),
             "hmc_terms": hmc_flops(b, k, d), "metric_bundle": bundle_flops(b, k, True, d),
             "g_inv": bundle_flops(b, k, False, d), "hmc_partials": partials_flops(b, k, d)}[name]
    return bound_ms(nbytes(*tensors), flops)


def run_latent_dim_kernel_checks(torch, dev):
    """B1, B4, B6, B7 and B8 at every D of LATENT_DIMS, K of LATENT_BANKS and
    B of LATENT_BATCHES, and at D = 32, K = 20 000, B = 64: each against its
    plain version and fp64, its structure, bit-identical on relaunch and in
    a CUDA-graph replay (at B = 64, K = 200 for every D, and at the wide
    case).  At D = 32, B = 64, K = 50 and 20 000: device ms per launch (a
    CUDA graph of GRAPH_LAUNCHES), CUDA-event ms, the plain version's ms and
    the bound."""
    from rlvae_tpu_torch.ops.metric_kernels import bank_width, launch_hmc_geometry

    cases, timed = [], {name: {} for name in BANK_KERNEL_NAMES}
    for d in LATENT_DIMS:
        for name in BANK_KERNEL_NAMES:
            for k in LATENT_BANKS:
                for b in LATENT_BATCHES:
                    case, _ = bank_kernel_case(torch, dev, name, d, k, b,
                                               replay=(k == 200 and b == SERVE_BATCH))
                    cases.append(case)
    for name in BANK_KERNEL_NAMES:
        for k in (50, LATENT_WIDE_K):
            case, (z, c, m, got) = bank_kernel_case(torch, dev, name, 32, k, SERVE_BATCH,
                                                    replay=k == LATENT_WIDE_K)
            if k == LATENT_WIDE_K:
                cases.append(case)
            kernel, plain = bank_kernel_calls(name, 32)
            rec = {"d": 32, "b": SERVE_BATCH, "k": k, "compiled_width": bank_width(32),
                   "geometry": list(launch_hmc_geometry(SERVE_BATCH, k, dev, name, 32)),
                   "ms": time_ms(torch, lambda: kernel(z, c, m), 20),
                   "device_ms": device_ms(torch, lambda: kernel(z, c, m))[0],
                   "plain_ms": time_ms(torch, lambda: plain(z, c, m), 5),
                   "max_abs_err": case["max_abs_err"]}
            rec["bound_ms"], rec["bound_by"] = bank_kernel_bound(name, SERVE_BATCH, k, 32,
                                                                 (z, c, m, *got))
            timed[name][f"K={k}"] = rec
    by_d = {n: {d: max(c["max_abs_err"] for c in cases if c["kernel"] == n and c["d"] == d)
                for d in LATENT_DIMS} for n in BANK_KERNEL_NAMES}
    worst_fp64 = {n: max(e["kernel_vs_fp64_abs"] / max(e["plain_vs_fp64_abs"], 1e-30)
                         for c in cases if c["kernel"] == n for e in c["errors"].values())
                  for n in BANK_KERNEL_NAMES}
    return {"n_cases": len(cases), "d32_b64": timed, "max_abs_err_by_d": by_d,
            "max_kernel_over_plain_fp64_err": worst_fp64,
            "graph_replays": sum("graph_replay_bit_identical" in c for c in cases),
            "max_abs_err": {n: max(c["max_abs_err"] for c in cases if c["kernel"] == n)
                            for n in BANK_KERNEL_NAMES},
            "tolerance": ("kernel vs plain and fp64 at the kernels phase's tolerances (B1 "
                          "CHOL_RTOL/ATOL and the bundle's fp64 rule, B4 HMC_LP_ATOL/HMC_RTOL, "
                          "B6/B7 BUNDLE_TOL, B8 PARTIALS_TOL); L upper triangle 0, G bitwise "
                          "symmetric, far rows exact; bit-identical on relaunch and in a "
                          "CUDA-graph replay")}


# The slice's path at latent 32 (published widths, random nets: the shipped
# 16-D encoder and decoder do not load there, and the model keeps its seeded
# init with a warning, as JAX's RlVAE does), and a model past the kernels'
# envelope at latent 48.
LATENT_WIDE = 32
LATENT_OVER = 48
# the components CLI cut to 16 synthetic sequences (128 frames: 2 VAE and 2
# RHVAE steps at its batch of 64) and one epoch of each stage
LATENT_COMPONENTS_CUT = ["--synthetic", "16", "--epochs", "1", "--metric-epochs", "1"]
LATENT_TRAIN_STEPS = 3
# the official chain's MCMC steps stepped on the card for the CPU replay
# (all 100), and the EP chain's (80 of the 100).  At latent 32 the target
# is sharp (log det G^{-1} sums 32 logs) and few proposals are accepted:
# 0.09-0.31% of rows a step on the components CLI's bank, which differs
# from run to run; 20 steps at B=64 held 2-3 accepted rows in one call and
# none in another.  At 0.09% the official chain expects 6 in 100 steps,
# at 0.125% the EP chain 6 in 80 (none with odds ~0.3% and ~0.2%), so
# each replay holds moved rows
LATENT_CHAIN_REPLAY_STEPS = 100
LATENT_EP_STEPS = 80
# of those, the CPU replays the first 10 steps and each step in which the
# card accepted a row: the plain terms at D = 32 are slow on the CPU
LATENT_REPLAYED_STEPS = 10
LATENT_EXPORT_BUCKET = 4
LATENT_OVER_BANK = 50           # the D=48 model's seeded bank
IAF_PLAIN_HIDDEN = 512          # an IAF chain past H = 256: the plain route


def latent_config(metric_path, d: int, base=None):
    """``base`` (the default preset) at latent ``d`` with ``metric_path``'s
    bank and the preset's temperature override; the shipped 16-D nets are
    named as the preset names them (they do not load at ``d``).  The flows
    start near the identity (log-sigma bias 0): at the reference init (-2)
    with random nets the chain scales z ~20x a transition, and the card's
    and the CPU's fp32 rounding came 2.6e-3 of scale apart over 7
    transitions at latent 32 (E2E_TOL's z_rel is 1e-3; ROADMAP C3), so the
    reference init is held to fp64 instead (:func:`latent_reference_init`)."""
    from rlvae_tpu_torch.models import PRESETS

    cfg = copy.deepcopy(base or PRESETS["riemannian_flow_vae"])
    cfg["latent_dim"] = d
    cfg["flow_log_var_bias_init"] = 0.0
    cfg["pretrained"] = {**cfg.get("pretrained", {}), "metric_path": str(metric_path)}
    return cfg


def latent_manager(torch, cfg, dev=None):
    """A ModelManager of ``cfg``, and whether the shipped nets were refused
    with a warning."""
    import warnings

    from rlvae_tpu_torch import ModelManager

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        manager = ModelManager.from_config(cfg, seed=0, device=dev)
    refused = any("pretrained components not loaded" in str(w.message) for w in caught)
    return manager, refused


def latent_components(torch, dev, out_dir: Path):
    """``python -m rlvae_tpu_torch.components --latent-dim 32`` (cut by
    LATENT_COMPONENTS_CUT) in this process on the card: every RHVAE step
    launches G^{-1} 16 times and nothing else, each RHVAE step is replayed on
    the CPU from the card's state (loss and grad norm at TRAIN_TOL), and the
    bank it writes is 32-D and finite."""
    from rlvae_tpu_torch import components
    from rlvae_tpu_torch.geometry import load_metric
    from rlvae_tpu_torch.geometry.pretrain import RHVAE

    steps, made = [], []

    def pre(module, args):
        if steps:
            steps[-1]["grad_norm"] = _grad_norm(torch, module)
        steps.append({"state": {k: v.detach().cpu().clone() for k, v in module.state_dict().items()},
                      "x": args[0].detach().cpu(),
                      "noise": {k: v.detach().cpu() for k, v in args[1].items()},
                      "before": launch_counts()})

    def post(module, args, result):
        steps[-1]["loss"] = float(result["loss"].detach())
        steps[-1]["launches"] = {k: v - steps[-1]["before"][k] for k, v in launch_counts().items()}

    def counted_rhvae(*args, **kwargs):
        m = RHVAE(*args, **kwargs)
        m.register_forward_pre_hook(pre)
        m.register_forward_hook(post)
        made.append(m)
        return m

    argv = ["--latent-dim", str(LATENT_WIDE), "--out-dir", str(out_dir), *LATENT_COMPONENTS_CUT]
    components.RHVAE, plain_rhvae = counted_rhvae, components.RHVAE
    try:
        t = time.perf_counter()
        summary, counts = counted(torch, lambda: components.main(argv))
        cli_s = time.perf_counter() - t
    finally:
        components.RHVAE = plain_rhvae
    steps[-1]["grad_norm"] = _grad_norm(torch, made[0])
    check(len(steps) >= 1, "the components CLI took no RHVAE step")
    g_inv_per_step = 5 * 3 + 1
    for i, rec in enumerate(steps):
        check(rec["launches"] == expected_launches(g_inv=g_inv_per_step),
              f"RHVAE step {i + 1} at latent {LATENT_WIDE} launched {rec['launches']}")
    cpu_rhvae = RHVAE(input_dim=tuple(steps[0]["x"].shape[1:]), latent_dim=LATENT_WIDE)
    errors = []
    for i, rec in enumerate(steps):
        cpu_rhvae.load_state_dict(rec["state"])
        cpu_rhvae.zero_grad(set_to_none=True)
        res = cpu_rhvae(rec["x"], rec["noise"])
        res["loss"].backward()
        loss_cpu, gn_cpu = float(res["loss"].detach()), _grad_norm(torch, cpu_rhvae)
        err = {"loss_rel": abs(rec["loss"] - loss_cpu) / abs(loss_cpu),
               "grad_norm_rel": abs(rec["grad_norm"] - gn_cpu) / gn_cpu}
        errors.append(err)
        check(np.isfinite(rec["loss"]) and err["loss_rel"] <= TRAIN_TOL["loss_rel"]
              and err["grad_norm_rel"] <= TRAIN_TOL["grad_norm_rel"],
              f"RHVAE step {i + 1} at latent {LATENT_WIDE}: card vs CPU {err}")
    bank = load_metric(out_dir / "metric.npz")
    check(bank.latent_dim == LATENT_WIDE and bool(torch.isfinite(bank.matrices).all())
          and bank.n_centroids == summary["n_centroids"],
          f"the components CLI wrote a {bank.latent_dim}-D bank of {bank.n_centroids}")
    return {"argv": argv, "cut": "16 synthetic sequences (200), 1 VAE epoch (50), 1 RHVAE "
                                 "epoch (10)", "host_s": cli_s, "launches": counts,
            "rhvae_steps": len(steps), "g_inv_per_rhvae_step": g_inv_per_step,
            "card_vs_cpu": errors, "n_centroids": bank.n_centroids,
            "temperature": bank.temperature}


def latent_serve(torch, manager):
    """One B=64 ``reconstruct`` bucket behind the engine (B1 x2 and B2, and
    nothing else), and a B=64 forward against the CPU."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, ServeConfig

    rng = np.random.default_rng(32)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(SERVE_BATCH,),
                                                              max_wait_ms=2000))
    try:
        engine.warmup({"reconstruct": seqs[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        rows = [f.result(timeout=60) for f in [engine.submit("reconstruct", s) for s in seqs]]
        torch.cuda.synchronize()
        counts = launch_counts()
        batches = engine.stats_snapshot()["batches"]
    finally:
        engine.stop()
    check(batches == 1 and counts == expected_launches(chol_bundle=2, iaf_chain_fwd=1),
          f"a latent-{LATENT_WIDE} reconstruct bucket launched {counts} in {batches} batches")
    check(all(r.shape == (8, 3, 64, 64) and np.isfinite(r).all() for r in rows),
          "bad reconstruct result")
    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, LATENT_WIDE)), dtype=torch.float32)
    out_gpu = manager.forward(seqs, eps=eps.to(manager.device))
    torch.cuda.synchronize()
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    return {"launches": counts, "cuda_vs_cpu": compare_forward(torch, out_gpu,
                                                                cpu.forward(seqs, eps=eps))}


def fp64_forward(torch, model, seqs, eps):
    """``model``'s forward (eval mode) on ``seqs`` with posterior noise
    ``eps``, in float64 on the CPU (the MLP nets' products too)."""
    import torch.nn.functional as F

    from rlvae_tpu_torch.nets import mlp

    model = copy.deepcopy(model).to("cpu").double()
    plain = mlp.dense
    mlp.dense = lambda layer, h, dtype: F.linear(h.double(), layer.weight.double(),
                                                 layer.bias.double())
    try:
        with torch.no_grad():
            return model(torch.from_numpy(seqs).double(), eps=eps.double())
    finally:
        mlp.dense = plain


def latent_reference_init(torch, bank_path, dev):
    """The default preset at latent 32 at its reference flow init (log-sigma
    bias -2; the rest of this phase starts near the identity), where the
    chain scales z ~20x a transition and fp32 rounding grows with it: a B=64
    forward (B1 2, B2 1) on the card and on the CPU, each held to an fp64
    forward on the CPU (z per time step relative to its largest entry, and
    the losses: the card's error at most FP64_GRAD_FACTOR x the CPU's, or
    E2E_TOL's); and one Trainer step replayed on the CPU (losses at
    TRAIN_TOL) with the card's and the CPU's gradients against fp64's
    (:func:`_train_and_replay`'s fp64 gate)."""
    from rlvae_tpu_torch import ModelManager
    from rlvae_tpu_torch.models import PRESETS

    cfg = {**latent_config(bank_path, LATENT_WIDE),
           "flow_log_var_bias_init": PRESETS["riemannian_flow_vae"]["flow_log_var_bias_init"]}
    manager, _ = latent_manager(torch, cfg, dev)
    rng = np.random.default_rng(33)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, LATENT_WIDE)), dtype=torch.float32)
    torch.cuda.synchronize()
    zero_launch_counts()
    out_card = manager.forward(seqs, eps=eps.to(manager.device))
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == expected_launches(chol_bundle=2, iaf_chain_fwd=1),
          f"a latent-{LATENT_WIDE} reference-init forward launched {counts}")
    out_cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu").forward(
        seqs, eps=eps)
    exact = fp64_forward(torch, manager.model, seqs, eps)

    def errors(out, want):
        a = {k: v.double().cpu() for k, v in out.items()}
        scale = want["z"].abs().amax(dim=(0, 2)).clamp_min(1e-12)
        got = {"z_rel": float(((a["z"] - want["z"]).abs().amax(dim=(0, 2)) / scale).max())}
        for k in ("kld_loss", "recon_loss", "flow_loss", "loss"):
            got[k] = float((a[k] - want[k]).abs() / want[k].abs().clamp_min(1e-12))
        return got

    want = {k: v.double() for k, v in exact.items()}
    card, cpu = errors(out_card, want), errors(out_cpu, want)
    for k, err in card.items():
        check(np.isfinite(err) and err <= max(FP64_GRAD_FACTOR * cpu[k], E2E_TOL[k]),
              f"latent-{LATENT_WIDE} reference-init forward vs fp64: {k} card {err}, CPU {cpu[k]}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_latent_") as run_dir:
        train = _train_and_replay(torch, run_dir, cfg, 1, None, dev, fp64=True, timed=False)
    launches = dict(counts)
    add_counts(launches, train["launches"])
    return {"init": cfg["flow_log_var_bias_init"], "forward_launches": counts,
            "forward_card_vs_fp64": card, "forward_cpu_vs_fp64": cpu,
            "forward_card_vs_cpu": errors(out_card, {k: v.double() for k, v in out_cpu.items()}),
            "train": train, "launches": launches}


def latent_generate(torch, manager):
    """``official`` and ``hmc`` at B=64: 1601 B4 a chain and one B2; the
    official chain's first LATENT_CHAIN_REPLAY_STEPS steps replayed on the
    CPU."""
    calls = []
    zero_launch_counts()
    for i, method in enumerate(("official", "hmc")):
        before = launch_counts()
        t = time.perf_counter()
        x = manager.sample_random_batched_seeds(list(range(64 * i, 64 * i + SERVE_BATCH)),
                                                method=method)
        host_s = time.perf_counter() - t
        got = {k: v - before[k] for k, v in launch_counts().items()}
        want = expected_launches(hmc_terms=CHAIN_LAUNCHES, iaf_chain_fwd=1)
        check(got == want, f"latent-{LATENT_WIDE} {method} launched {got}, expected {want}")
        check(x.shape == (SERVE_BATCH, 8, 3, 64, 64) and np.isfinite(x).all(),
              f"bad latent-{LATENT_WIDE} {method} output")
        calls.append({"method": method, "batch": SERVE_BATCH, "host_s": host_s, "launches": got})
    return {"calls": calls, "launches": launch_counts(),
            "chain_card_vs_cpu": replay_chain(torch, manager, LATENT_CHAIN_REPLAY_STEPS,
                                              LATENT_REPLAYED_STEPS)}


def latent_geodesic(torch, bank_path, dev):
    """``hybrid_rlvae`` with ``sampling.method: geodesic`` at latent 32 on the
    CLI's bank: one B=64 reconstruct bucket (B6 and B2) and one Trainer step
    replayed on the CPU (B6, B2, B3; its validation B7)."""
    from rlvae_tpu_torch import BatchingEngine, ServeConfig

    cfg = latent_config(bank_path, LATENT_WIDE, geodesic_hybrid_config())
    manager, _ = latent_manager(torch, cfg, dev)
    seqs = np.random.default_rng(33).uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(SERVE_BATCH,),
                                                              max_wait_ms=2000))
    try:
        engine.warmup({"reconstruct": seqs[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        rows = [f.result(timeout=60) for f in [engine.submit("reconstruct", s) for s in seqs]]
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        engine.stop()
    check(counts == expected_launches(metric_bundle=1, iaf_chain_fwd=1),
          f"a latent-{LATENT_WIDE} geodesic bucket launched {counts}")
    check(all(np.isfinite(r).all() for r in rows), "bad geodesic reconstruct")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_latent_") as run_dir:
        train = _train_and_replay(
            torch, run_dir, cfg, 1,
            expected_launches(metric_bundle=1, iaf_chain_fwd=1, iaf_chain_bwd=1), dev,
            witness=True)
    return {"bucket_launches": counts, "train": train,
            "launches": {k: counts[k] + train["launches"][k] for k in counts}}


def latent_ep(torch, bank):
    """The official chain through ``sample_prior_hmc_sharded`` at latent 32
    and B=64, LATENT_EP_STEPS MCMC steps (1 + 16 per step B8 launches and
    no B4), stepped one step at a time and replayed on the CPU and against
    the dense B4 terms."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.parallel import create_mesh, sample_prior_hmc_sharded
    from rlvae_tpu_torch.samplers import HMCConfig, draw_hmc_noise

    mesh = create_mesh()
    cfg = HMCConfig(mcmc_steps=LATENT_EP_STEPS)
    noise = draw_hmc_noise(bank, SERVE_BATCH, cfg,
                           torch.Generator(device=bank.centroids.device).manual_seed(19))
    (z, diag), launches = counted(torch, lambda: sample_prior_hmc_sharded(
        mesh, bank, SERVE_BATCH, cfg, **noise, return_diagnostics=True))
    want = expected_launches(hmc_partials=1 + LATENT_EP_STEPS * (cfg.n_lf + 1))
    check(launches == want, f"the latent-{LATENT_WIDE} EP chain launched {launches}")
    check(z.shape == (SERVE_BATCH, LATENT_WIDE) and bool(torch.isfinite(z).all()),
          "bad EP chain output")
    cpu_bank = CentroidMetric(bank.centroids.cpu(), bank.matrices.cpu(), bank.temperature,
                              bank.regularization)
    return {"mcmc_steps": LATENT_EP_STEPS, "launches": launches,
            "accept_rate": float(diag["accept_rate"]),
            "replay": replay_ep_chain(torch, bank, cpu_bank, noise, cfg, z,
                                      LATENT_REPLAYED_STEPS)}


def latent_export(torch, manager, tmp: Path):
    """``reconstruct`` exported at latent 32 and bucket LATENT_EXPORT_BUCKET,
    loaded on the card: two B1 and one B2 in the graph and launched per run,
    bit for bit the live manager."""
    from rlvae_tpu_torch.export import export_model, load_exported

    b = LATENT_EXPORT_BUCKET
    t = time.perf_counter()
    manifest = export_model(manager, tmp, ops=("reconstruct",), buckets=(b,))
    export_s = time.perf_counter() - t
    ops = manifest["programs"]["reconstruct"][str(b)]["registered_ops"]
    check(ops == {**dict.fromkeys(ops, 0), "chol_bundle": 2, "iaf_chain_fwd": 1},
          f"the latent-{LATENT_WIDE} reconstruct program holds {ops}")
    bundle = load_exported(tmp, device=manager.device)
    x = np.random.default_rng(34).uniform(size=(b, 8, 3, 64, 64)).astype(np.float32)
    bundle.run("reconstruct", x)  # warm
    got, launches = counted(torch, lambda: bundle.run("reconstruct", x))
    check(launches == expected_launches(chol_bundle=2, iaf_chain_fwd=1),
          f"the latent-{LATENT_WIDE} program launched {launches}")
    want = manager.reconstruct(x, seed=0)
    check(np.array_equal(got, want), "the latent-32 program differs from the live manager")
    return {"bucket": b, "export_s": export_s, "registered_ops": ops, "launches": launches,
            "bitwise_vs_manager": True}


def latent_over(torch, dev, tmp: Path):
    """A model past the kernels' envelope (latent 48, a seeded K=50 bank):
    a B=64 forward (``reconstruct``'s) and one ``geodesic`` generate on the
    card take the plain routes (no B1/B2/B4/B6/B7/B8 launch, a non-zero
    ``plain_route.calls``), against the CPU; then one IAF chain at H = 512
    (latent 16) on the plain route, against the CPU."""
    from rlvae_tpu_torch import ModelManager
    from rlvae_tpu_torch.flows import TemporalFlows, apply_temporal_flows
    from rlvae_tpu_torch.geometry.loader import save_metric
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.ops._launch import plain_route

    c, m = latent_bank(LATENT_OVER, LATENT_OVER_BANK, 48)
    save_metric(CentroidMetric.create(c, m, 1.0, 0.01), tmp / "metric48.npz")
    manager, refused = latent_manager(torch, latent_config(tmp / "metric48.npz", LATENT_OVER), dev)
    rng = np.random.default_rng(48)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, LATENT_OVER)), dtype=torch.float32)
    before = plain_route.calls
    out_gpu, launches = counted(torch, lambda: manager.forward(seqs, eps=eps.to(manager.device)))
    gen = torch.Generator(device=manager.device).manual_seed(29)
    noise = manager.model.draw_generation_noise(SERVE_BATCH, "geodesic", gen)
    with torch.no_grad():
        x_gpu, gen_launches = counted(torch, lambda: manager.model.generate(
            SERVE_BATCH, 8, "geodesic", noise=noise))
    plain_calls = plain_route.calls - before
    check(launches == expected_launches() and gen_launches == expected_launches(),
          f"the latent-{LATENT_OVER} model launched {launches} and {gen_launches}")
    check(plain_calls > 0, "the latent-48 model took no plain route")
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    compare = compare_forward(torch, out_gpu, cpu.forward(seqs, eps=eps))
    with torch.no_grad():
        x_cpu = cpu.model.generate(SERVE_BATCH, 8, "geodesic",
                                   noise={k: v.cpu() for k, v in noise.items()})
    gen_err = float((x_gpu.float().cpu() - x_cpu.float()).abs().mean())
    check(gen_err <= E2E_TOL["recon_mean_abs"],
          f"latent-{LATENT_OVER} geodesic generate card vs CPU: {gen_err}")

    torch.manual_seed(0)
    flows = TemporalFlows(16, n_flows=2, hidden_size=IAF_PLAIN_HIDDEN, log_var_bias_init=0.0)
    z0 = torch.randn(SERVE_BATCH, 16)
    before = plain_route.calls
    with torch.no_grad():
        (z_gpu, ld_gpu), iaf_launches = counted(torch, lambda: apply_temporal_flows(
            copy.deepcopy(flows).to(dev or "cuda"), z0.to(dev or "cuda"), 8))
        z_cpu, ld_cpu = apply_temporal_flows(flows, z0, 8)
    iaf_plain = plain_route.calls - before
    check(iaf_launches == expected_launches() and iaf_plain == 1,
          f"the H={IAF_PLAIN_HIDDEN} chain launched {iaf_launches}, {iaf_plain} plain calls")
    iaf_err = _scaled(z_gpu, z_cpu)
    check(iaf_err <= IAF_RTOL and _scaled(ld_gpu, ld_cpu) <= IAF_RTOL,
          f"the H={IAF_PLAIN_HIDDEN} chain card vs CPU: {iaf_err}")
    return {"latent_dim": LATENT_OVER, "shipped_nets_refused": refused,
            "forward_launches": launches, "generate_launches": gen_launches,
            "plain_route_calls": plain_calls, "cuda_vs_cpu": compare,
            "geodesic_generate_mean_abs": gen_err,
            "iaf_h512": {"launches": iaf_launches, "plain_route_calls": iaf_plain,
                         "z_rel_err": iaf_err}}


# B5 past 512 hidden units (csrc/decode_mse_wide.cu): mlp_rlvae's decoder
# [256, 512, 1024] ends at K = 1024
DECODE_WIDE_K = 1024
DECODE_WIDE_SHAPES = ((TRAIN_BATCH * 8, 12288), (37, 300))
MLP_FUSED_STEPS = 2


def decode_wide_inputs(torch, dev, m: int, n: int, k: int, seed: int):
    """Decoder-like inputs at hidden width k: h post-ReLU (bf16), W [N, K] and
    b at a Linear init's scale, targets in [0, 1], rw = 1/B with rows 3 and
    4 at 0."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    rw = np.full((m,), 1.0 / TRAIN_BATCH)
    rw[3:5] = 0.0
    return (t(np.maximum(rng.normal(size=(m, k)), 0.0)).to(torch.bfloat16),
            t(rng.uniform(-1, 1, size=(n, k)) / np.sqrt(k)),
            t(rng.uniform(-1, 1, size=(n,)) / np.sqrt(k)), t(rng.uniform(size=(m, n))), t(rw))


def decode_wide_checks(torch, dev):
    """decode+MSE's three entry points at K = 1024 against their plain
    versions at the kernels phase's tolerances (the loss also fp64),
    bit-identical on relaunch and in a CUDA-graph replay, the dW/db entry
    on the dp that the dh entry left (as DecodeMSE's backward calls it)
    bitwise its own; device ms at M = 128, N = 12288 beside the plain
    version and the bound, the two backward entries as DecodeMSE calls
    them (dh fills the dp workspace, dW/db reads it)."""
    from rlvae_tpu_torch.ops.recon_kernels import (
        decode_mse,
        decode_mse_bwd_dh,
        decode_mse_bwd_dw,
        decode_mse_dh_ref,
        decode_mse_dw_ref,
        decode_mse_ref,
        wide_dp,
    )

    g = torch.ones((), device=dev)
    k, cases, timed = DECODE_WIDE_K, [], {}
    for m, n in DECODE_WIDE_SHAPES:
        args = decode_wide_inputs(torch, dev, m, n, k, m + n)
        h, w, b, x, rw = args
        dp = wide_dp(h, x)
        kernels = (lambda: decode_mse(*args), lambda: decode_mse_bwd_dh(*args, g, dp),
                   lambda: decode_mse_bwd_dw(*args, g, dp))
        loss, dh, (dw, db) = (f() for f in kernels)
        shared = all(map(torch.equal, (dw, db), decode_mse_bwd_dw(*args, g)))
        again = (kernels[0](), kernels[1](), *kernels[2]())
        same = all(map(torch.equal, (loss, dh, dw, db), again))
        replayed = graph_replay_equal(torch, lambda: (kernels[0](), kernels[1](), *kernels[2]()),
                                      (loss, dh, dw, db))
        ref = decode_mse_ref(*args)
        ref64 = decode_mse_ref(h, w.double(), b.double(), x.double(), rw.double())
        dh_p = decode_mse_dh_ref(*args, g)
        dh32, dh32_p = decode_mse_bwd_dh(h.float(), w, b, x, rw, g), decode_mse_dh_ref(
            h.float(), w, b, x, rw, g)
        dw_p, db_p = decode_mse_dw_ref(*args, g)
        torch.cuda.synchronize()
        err_k, err_p = abs(float(loss) - float(ref64)), abs(float(ref) - float(ref64))

        def within(got, want):
            return float((got.float() - want.float()).abs().max()) <= (
                DECODE_GRAD_RTOL * float(want.float().abs().max()))

        d, ref_abs = (dh.float() - dh_p.float()).abs(), dh_p.float().abs()
        case = {"shape": f"M={m},K={k},N={n}",
                "loss_rel": abs(float(loss) - float(ref)) / abs(float(ref)),
                "loss_vs_fp64": err_k, "plain_loss_vs_fp64": err_p,
                "dh_bf16_max_abs": float(d.max()), "dh_fp32_ok": within(dh32, dh32_p),
                "dw_ok": within(dw, dw_p), "db_ok": within(db, db_p),
                "max_abs_err": max(float(d.max()), float((dw - dw_p).abs().max()),
                                   float((db - db_p).abs().max())),
                "masked_rows_zero": bool(torch.all(dh[3:5] == 0)),
                "shared_dp_bitwise_own": shared,
                "bit_identical_on_relaunch": same, "bit_identical_in_graph_replay": replayed}
        case["ok"] = (case["loss_rel"] <= DECODE_LOSS_RTOL
                      and err_k <= max(DECODE_FP64_FACTOR * err_p,
                                       DECODE_FP64_RTOL * abs(float(ref64)))
                      and bool(torch.all(d <= 2.0 ** -7 * ref_abs
                                         + DECODE_GRAD_RTOL * float(ref_abs.max())))
                      and case["dh_fp32_ok"] and case["dw_ok"] and case["db_ok"]
                      and case["masked_rows_zero"] and shared and same and replayed)
        check(case["ok"], f"decode+MSE at K={k} disagrees: {case}")
        cases.append(case)
        if n == 12288:
            mkn, ins = 2.0 * m * k * n, nbytes(h, w, b, x, rw)
            plains = (lambda: decode_mse_ref(*args), lambda: decode_mse_dh_ref(*args, g),
                      lambda: decode_mse_dw_ref(*args, g))
            for name, kernel, plain, n_bytes, n_ops in zip(
                    ("decode_mse_fwd", "decode_mse_bwd_dh", "decode_mse_bwd_dw"), kernels, plains,
                    (ins + 4, ins + 4 + nbytes(h), ins + 4 + nbytes(w, b)), (mkn, 2 * mkn, 2 * mkn)):
                bms, by = bound_ms(n_bytes, n_ops, PEAK_BF16_TENSOR_FLOPS)
                timed[name] = {"shape": case["shape"], "device_ms": device_ms(torch, kernel)[0],
                               "ms": time_ms(torch, kernel, 5), "plain_ms": time_ms(torch, plain, 3),
                               "bound_ms": bms, "bound_by": by}
    return {"cases": cases, "timed": timed,
            "source": "rlvae_tpu_torch/csrc/decode_mse_wide.cu",
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def latent_mlp_fused(torch, dev):
    """MLP_FUSED_STEPS Trainer steps of ``mlp_rlvae`` with the fused
    decode+MSE loss (``model.fused_decode_mse=true``, dropout 0 in both nets
    so the CPU replays the card's steps; the nets' published widths, the
    shipped 16-D nets refused): each step launches B1 2, B2 1, B3 1 and the
    wide B5's three entry points once (K = 1024), replayed on the CPU at the
    near-identity flow init."""
    cfg = conv_config("mlp_rlvae", "model.encoder.dropout=0", "model.decoder.dropout=0",
                      "model.fused_decode_mse=true")["model"]
    check(cfg["decoder"]["hidden_dims"][-1] == DECODE_WIDE_K, f"mlp_rlvae decoder {cfg['decoder']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mlp_fused_") as run_dir:
        return _train_and_replay(
            torch, run_dir, {**cfg, "flow_log_var_bias_init": 0.0}, MLP_FUSED_STEPS,
            expected_launches(chol_bundle=2, iaf_chain_fwd=1, iaf_chain_bwd=1, decode_mse_fwd=1,
                              decode_mse_bwd_dh=1, decode_mse_bwd_dw=1), dev, witness=True)


def run_latent_dims(torch, dev=None):
    """The latent_dims phase: the bank kernels at every width
    (:func:`run_latent_dim_kernel_checks`), then the slice's path at latent
    32 with the launch counters zeroed before each part and read after it
    and ``plain_route.calls`` held at 0 throughout: the components CLI
    writes a 32-D bank; the default preset on it serves a reconstruct bucket,
    trains LATENT_TRAIN_STEPS steps and generates with both chains, and at
    its reference flow init runs a forward and a step held to fp64; the
    geodesic hybrid serves a bucket and trains a step; the EP chain; the
    exported reconstruct.  Then the latent-48 model and the H=512 chain on
    the plain routes."""
    from rlvae_tpu_torch.ops._launch import plain_route

    dev = dev or torch.device("cuda")
    out, laps, total = {}, {}, {}
    t = time.perf_counter()
    out["kernels"] = run_latent_dim_kernel_checks(torch, dev)
    laps["kernels"] = time.perf_counter() - t
    plain_before = plain_route.calls
    with tempfile.TemporaryDirectory(prefix="chip_smoke_latent_") as tmp:
        tmp = Path(tmp)
        t = time.perf_counter()
        out["components"] = latent_components(torch, dev, tmp / "components")
        add_counts(total, out["components"]["launches"])
        bank_path = tmp / "components" / "metric.npz"
        cfg = latent_config(bank_path, LATENT_WIDE)
        manager, refused = latent_manager(torch, cfg, dev)
        check(refused and manager.model.latent_dim == LATENT_WIDE
              and manager.model.metric.latent_dim == LATENT_WIDE,
              "the latent-32 model did not keep its init with a warning")
        laps["components"] = time.perf_counter() - t
        t = time.perf_counter()
        out["serve"] = latent_serve(torch, manager)
        add_counts(total, out["serve"]["launches"])
        with tempfile.TemporaryDirectory(prefix="chip_smoke_latent_") as run_dir:
            out["train"] = _train_and_replay(
                torch, run_dir, cfg, LATENT_TRAIN_STEPS, None, dev, witness=True)
        add_counts(total, out["train"]["launches"])
        out["generate"] = latent_generate(torch, manager)
        add_counts(total, out["generate"]["launches"])
        laps["default_model"] = time.perf_counter() - t
        t = time.perf_counter()
        out["reference_init"] = latent_reference_init(torch, bank_path, dev)
        add_counts(total, out["reference_init"]["launches"])
        laps["reference_init"] = time.perf_counter() - t
        t = time.perf_counter()
        out["geodesic"] = latent_geodesic(torch, bank_path, dev)
        add_counts(total, out["geodesic"]["launches"])
        out["ep"] = latent_ep(torch, manager.model.metric)  # the bank at the preset's T
        add_counts(total, out["ep"]["launches"])
        laps["geodesic_ep"] = time.perf_counter() - t
        t = time.perf_counter()
        out["export"] = latent_export(torch, manager, tmp / "bundle")
        add_counts(total, out["export"]["launches"])
        laps["export"] = time.perf_counter() - t
        out["plain_route_calls"] = plain_route.calls - plain_before
        check(out["plain_route_calls"] == 0,
              f"the latent-{LATENT_WIDE} path took the plain route {out['plain_route_calls']} times")
        t = time.perf_counter()
        out["over"] = latent_over(torch, dev, tmp)
        laps["over"] = time.perf_counter() - t
    t = time.perf_counter()
    out["decode_wide"] = decode_wide_checks(torch, dev)
    out["mlp_fused"] = latent_mlp_fused(torch, dev)
    add_counts(total, out["mlp_fused"]["launches"])
    laps["decode_wide"] = time.perf_counter() - t
    out["launches"] = total
    out["laps_s"] = laps
    out["cut"] = {"components": out["components"]["cut"],
                  "ep_mcmc_steps": f"{LATENT_EP_STEPS} (100)",
                  "official_chain_stepped_steps": f"{LATENT_CHAIN_REPLAY_STEPS} (100)",
                  "cpu_replayed_steps": f"the first {LATENT_REPLAYED_STEPS} and each that "
                                        "accepted a row",
                  "geodesic_train_steps": 1}
    return out


def _grad_norm(torch, module) -> float:
    return float(torch.sqrt(sum((p.grad.detach().float() ** 2).sum()
                                for p in module.parameters() if p.grad is not None)))


def main() -> None:
    faulthandler.dump_traceback_later(HANG_GUARD_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    from rlvae_tpu_torch.ops.build import kernel_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's deterministic algorithms, so each call checks the same
    # computation: with its default ones the convnets phase's bf16 cnn step 2
    # (from a reference-init step 1 whose card-vs-CPU grad_norm differs 47x)
    # read BatchNorm statistics 4e-4 to 7e-4 from the CPU in four calls and
    # 0.28 in one; deterministic, 1.2e-3 in two
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    lib = kernel_library()
    emit("build", seconds=lib.seconds, library=str(lib.path.name),
         ptxas=[ln.strip() for ln in lib.log.splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln])
    print(f"build_seconds {lib.seconds:.3f}", flush=True)

    records = {}
    t_kernels = time.perf_counter()
    for name, run in (("chol_bundle", run_chol_checks), ("iaf_chain_fwd", run_iaf_checks),
                      ("iaf_chain_bwd", run_iaf_bwd_checks), ("hmc_terms", run_hmc_checks),
                      ("hmc_partials", run_partials_checks)):
        records[name], cases = run(torch, dev)
        emit("kernels", kernel=name, tolerance=records[name]["tolerance"], cases=cases)
    for name, (record, cases) in run_bundle_checks(torch, dev).items():
        records[name] = record
        emit("kernels", kernel=name, tolerance=record["tolerance"], cases=cases)
    for name, (record, cases) in run_decode_checks(torch, dev).items():
        records[name] = record
        emit("kernels", kernel=name, tolerance=record["tolerance"], cases=cases)
    jacobi = run_iaf_jacobi_checks(torch, dev)
    emit("kernels", kernel="iaf_chain_fwd+iaf_chain_bwd (Jacobi mode)",
         tolerance=jacobi["tolerance"], cases=jacobi["cases"])
    seq_checks = run_iaf_seq_bwd_checks(torch, dev)
    emit("kernels", kernel="iaf_chain_bwd (sequential mode)", tolerance=seq_checks["tolerance"],
         cases=seq_checks["cases"], timing_b64=seq_checks["timing_b64"])
    PHASE_S["build"] = round(lib.seconds, 3)
    PHASE_S["kernels"] = round(time.perf_counter() - t_kernels, 3)

    # every phase before seq_bwd runs the backward in the adjoint mode (in
    # this process: the dp phase's ranks count in their own)
    seq_before_paths = sequential_bwd_launches()
    serve = phase("serve", run_serve, torch)
    train = phase("train", run_train, torch)
    generate = phase("generate", run_generate, torch)
    posterior = phase("posterior", run_posterior, torch)
    fast = phase("fast", run_fast, torch)
    ep = phase("ep", run_ep, torch)
    dense = phase("dense_chain", run_dense_chain, torch)
    checkpoint = phase("checkpoint", run_checkpoint, torch)
    adaptive = phase("adaptive", run_adaptive, torch)
    exp = phase("experiment", run_experiment, torch)
    conv = phase("convnets", run_convnets, torch)
    geometry = phase("geometry", run_geometry, torch)
    dp = phase("dp", run_dp, torch, nvidia_smi=smi)
    fixedpoint = phase("fixedpoint", run_fixedpoint, torch)
    research = phase("research", run_research, torch)
    check(sequential_bwd_launches() == seq_before_paths,
          f"{sequential_bwd_launches() - seq_before_paths} sequential backward launches in the "
          f"adjoint paths")
    seq_bwd = phase("seq_bwd", run_seq_bwd, torch)
    deploy = phase("deploy", run_deploy, torch, nvidia_smi=smi)
    viz = phase("viz", lambda t: run_viz(t, chol_device_ms=records["chol_bundle"]["device_ms"]),
                torch, nvidia_smi=smi)
    latent = phase("latent_dims", run_latent_dims, torch, nvidia_smi=smi)
    emit("phase_seconds", **PHASE_S)
    # launches: the sum over the main paths' runs (each read between
    # zeroing the counters and the end of its run), with each path's count
    # beside it; every kernel is launched by the paths it belongs to
    paths = {"serve": (serve["launches"], ("chol_bundle", "iaf_chain_fwd")),
             "train": (train["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                           "g_inv")),
             "generate": (generate["launches"], ("chol_bundle", "iaf_chain_fwd", "hmc_terms",
                                                 "g_inv")),
             "posterior": (posterior["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                                   "metric_bundle", "g_inv")),
             "fast": (fast["launches"], ("chol_bundle", "g_inv", "decode_mse_fwd",
                                         "decode_mse_bwd_dh", "decode_mse_bwd_dw")),
             "ep": (ep["launches"], ("hmc_partials",)),
             "dense_chain": (dense["launches"], ("hmc_terms",)),
             "checkpoint": (checkpoint["launches"], ("chol_bundle", "iaf_chain_fwd",
                                                     "iaf_chain_bwd", "g_inv")),
             "adaptive": (adaptive["launches"], ("hmc_terms", "iaf_chain_fwd")),
             "budget": (adaptive["budget"]["launches"], ("hmc_terms", "iaf_chain_fwd")),
             "nll": (adaptive["nll"]["launches"], ("chol_bundle", "iaf_chain_fwd")),
             "posterior_hmc": (adaptive["posterior_hmc"]["launches"], ("hmc_terms",
                                                                       "iaf_chain_fwd")),
             "experiment": (exp["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                              "g_inv", "metric_bundle", "decode_mse_fwd",
                                              "decode_mse_bwd_dh", "decode_mse_bwd_dw")),
             "convnets": (conv["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                             "g_inv", "hmc_terms")),
             "geometry": (geometry["launches"], ("chol_bundle", "iaf_chain_fwd", "hmc_terms",
                                                 "metric_bundle", "g_inv")),
             "dp": (dp["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                     "decode_mse_fwd", "decode_mse_bwd_dh",
                                     "decode_mse_bwd_dw")),
             "fixedpoint": (fixedpoint["launches"], ("chol_bundle", "iaf_chain_fwd",
                                                     "iaf_chain_bwd", "g_inv")),
             "research": (research["launches"], ("chol_bundle", "metric_bundle", "hmc_terms")),
             "seq_bwd": (seq_bwd["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                               "g_inv")),
             "deploy": (deploy["launches"], ("chol_bundle", "iaf_chain_fwd", "g_inv")),
             "deploy_methods": (deploy["methods"]["launches"], ("chol_bundle", "iaf_chain_fwd",
                                                                "hmc_terms", "metric_bundle",
                                                                "g_inv")),
             "viz": (viz["launches"], ("chol_bundle", "iaf_chain_fwd", "metric_bundle", "g_inv")),
             "latent_dims": (latent["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                                  "hmc_terms", "metric_bundle", "g_inv",
                                                  "hmc_partials", "decode_mse_fwd",
                                                  "decode_mse_bwd_dh", "decode_mse_bwd_dw"))}
    for path, (counts, kernels) in paths.items():
        for name in kernels:
            check(counts[name] > 0, f"the {path} path did not launch {name}")
    for name, rec in records.items():
        rec["launches"] = sum(counts[name] for counts, _ in paths.values())
        for path, (counts, _) in paths.items():
            rec[f"launches_{path}"] = counts[name]
        rec["launches_per_train_step"] = train["launches_per_step"][name]
        # measured on rank 0's first step: the one-rank NCCL world, the
        # two-rank gloo world's DP and DP x TP layouts, the fast preset's DP x TP
        rec["launches_per_dp_train_step_per_rank"] = {
            key: dp["launches_per_step"][key].get(name, 0)
            for key in ("nccl1_1", "gloo2_1", "gloo2_2", "gloo2_riemannian_flow_vae_fast")}
        rec["launches_per_geodesic_train_step"] = posterior["train"]["launches_per_step"][name]
        rec["launches_per_fast_train_step"] = fast["train"]["launches_per_step"][name]
        rec["launches_per_convnet_train_step"] = {
            m: conv[m]["train"]["launches_per_step"][name] for m in CONVNET_MODELS}
    records["hmc_terms"]["launches_per_official_chain"] = next(
        c["launches"]["hmc_terms"] for c in generate["calls"] if c["method"] == "official")
    records["metric_bundle"]["launches_per_geodesic_forward"] = (
        posterior["metric_bundle_launches_per_forward"])
    records["metric_bundle"]["launches_per_geodesic_interpolation"] = (
        geometry["interpolate"]["launches"]["metric_bundle"])
    records["metric_bundle"]["launches_per_log_map"] = (
        geometry["shooting"]["log_map_launches"]["metric_bundle"])
    records["g_inv"]["launches_per_rhvae_step"] = geometry["rhvae"]["g_inv_per_step"]
    records["hmc_partials"]["launches_per_ep_chain"] = ep["launches"]["hmc_partials"]
    # the Jacobi mode (fixedpoint phase: K=8, backward at 9 sweeps) of B2/B3
    for name, mode in (("iaf_chain_fwd", "fwd"), ("iaf_chain_bwd", "bwd")):
        records[name]["jacobi"] = {
            "cases": [c["shape"] for c in jacobi["cases"]], "tolerance": jacobi["tolerance"],
            "timing_b64": jacobi["timing_b64"][mode],
            "launches_per_fixedpoint_train_step":
                fixedpoint["train"]["launches_per_step"][name]}
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           max(c["max_abs_err"] for c in jacobi["cases"]))
    records["iaf_chain_fwd"]["jacobi"]["launches_per_fixedpoint_reconstruct_bucket"] = (
        fixedpoint["reconstruct_bucket"]["launches"]["iaf_chain_fwd"])
    # the sequential mode of B3 (seq_bwd phase: ADJ_SWEEPS_OVERRIDE = 0)
    records["iaf_chain_bwd"]["sequential"] = {
        "cases": [c["shape"] for c in seq_checks["cases"]], "tolerance": seq_checks["tolerance"],
        "timing_b64": seq_checks["timing_b64"],
        "launches_seq_bwd": seq_bwd["launches"]["iaf_chain_bwd"],
        "launches_per_seq_bwd_train_step": seq_bwd["train"]["launches_per_step"]["iaf_chain_bwd"],
        "vs_adjoint_gradients": seq_bwd["vs_adjoint"]}
    records["iaf_chain_bwd"]["max_abs_err"] = max(
        records["iaf_chain_bwd"]["max_abs_err"], *(c["max_abs_err"] for c in seq_checks["cases"]))
    records["hmc_terms"]["k1"] = research["gugus_lvaegg"]["hmc_terms_k1"]
    records["hmc_terms"]["launches_per_gugus_generate_hmc"] = (
        research["gugus_lvaegg"]["generate_hmc_launches"])
    for name in ("chol_bundle", "metric_bundle", "hmc_terms"):
        records[name]["launches_research_by_model"] = {
            m: research[m]["launches"][name] for m in ("lvae_iaf", "riem", "gugus_lvaegg")}
    for name, rec in records.items():
        rec["launches_lldm"] = research["lldm"]["launches"][name]
    # the exported programs' launches at B=64, by the counters and by the profiler
    for name, label in KERNEL_LABELS.items():
        records[name]["launches_per_exported_program"] = {
            op: p["counted"][label] for op, p in deploy["programs"].items()}
        records[name]["profiled_launches_per_exported_program"] = {
            op: p["kernels"][label] for op, p in deploy["programs"].items()}
    # the other methods' exported programs: each call's launches (the bundle's,
    # equal to the live manager's), by the counters
    for name in ("chol_bundle", "iaf_chain_fwd", "hmc_terms", "metric_bundle", "g_inv"):
        records[name]["launches_per_exported_method_call"] = {
            m: p["launches_per_call"].get(name, 0)
            for m, p in deploy["methods"]["programs"].items()}
    records["hmc_terms"]["launches_per_dense_k20000_chain"] = dense["launches"]["hmc_terms"]
    records["hmc_terms"]["launches_per_calibration_phase"] = [
        p["hmc_terms"] for p in adaptive["calibration"]["phases"]]
    records["hmc_terms"]["launches_per_planned_generate"] = (
        adaptive["generate"]["hmc_terms_per_batch"])
    records["hmc_terms"]["launches_per_posterior_hmc_forward"] = (
        adaptive["posterior_hmc"]["launches"]["hmc_terms"] // adaptive["posterior_hmc"]["batches"])
    records["chol_bundle"]["launches_per_estimate_nll"] = adaptive["nll"]["launches"]["chol_bundle"]
    records["iaf_chain_fwd"]["launches_per_estimate_nll"] = (
        adaptive["nll"]["launches"]["iaf_chain_fwd"])
    for name, rec in records.items():
        rec["launches_per_experiment_run"] = {
            "single": exp["single"]["launches"][name],
            **{f"comparison_{m}": r["launches"][name] for m, r in exp["comparison"].items()},
            **{f"multirun_{m}": r["launches"][name] for m, r in exp["multirun"].items()},
            "fast": exp["fast"]["launches"][name]}

    # every latent width: the checks' worst error per width, and at D = 32
    # the times beside the bound (latent_dims phase)
    for name in BANK_KERNEL_NAMES:
        records[name]["latent_dims"] = {
            "max_abs_err_by_d": latent["kernels"]["max_abs_err_by_d"][name],
            "d32_b64": latent["kernels"]["d32_b64"][name],
            "launches_latent32_path": latent["launches"].get(name, 0)}
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           latent["kernels"]["max_abs_err"][name])
    for name, t in latent["decode_wide"]["timed"].items():
        records[name]["k1024"] = {**t, "source": latent["decode_wide"]["source"],
                                  "launches_mlp_fused": latent["mlp_fused"]["launches"][name]}
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           latent["decode_wide"]["max_abs_err"])
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


def replay_witness() -> None:
    """``python3 chip_smoke.py --replay-witness``: the readings behind
    TRAIN_TOL's and ENCODER_HEAD_TOL's comments, report-only.  The
    train-step replays of :func:`run_train` (3 steps) at the native
    loader's batches for the default, geodesic hybrid, fast, fixedpoint and
    sequential-backward paths, with bf16 and fp32 nets at the reference
    and the near-identity flow init; then a default model trained 5 steps
    on the card, its forward against the CPU with bf16 and fp32 nets, and
    through :func:`compare_trained_forward`.  One JSON line each, with the
    checks that would have failed."""
    global check
    import torch

    from rlvae_tpu_torch.models import PRESETS
    from rlvae_tpu_torch.ops import iaf_kernels
    from rlvae_tpu_torch.ops.build import kernel_library

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    emit("device", nvidia_smi=nvidia_smi(), build_s=kernel_library().seconds)
    gate, failed = check, []
    check = lambda ok, what: ok or failed.append(what)  # noqa: E731

    def nets(cfg, dtype, bias):
        return {**cfg, "encoder": {**cfg["encoder"], "dtype": dtype},
                "decoder": {**cfg["decoder"], "dtype": dtype}, "flow_log_var_bias_init": bias}

    default = PRESETS["riemannian_flow_vae"]
    paths = {"default": (default, None, None),
             "geodesic": (geodesic_hybrid_config(), expected_launches(
                 metric_bundle=1, iaf_chain_fwd=1, iaf_chain_bwd=1), None),
             "fast": (PRESETS["riemannian_flow_vae_fast"], expected_launches(
                 chol_bundle=2, decode_mse_fwd=1, decode_mse_bwd_dh=1, decode_mse_bwd_dw=1), None),
             "fixedpoint": ({**default, "flow_fixedpoint_iters": FIXEDPOINT_ITERS}, None, None),
             "seq_bwd": (default, None, 0)}
    try:
        for path, (cfg, per_step, sweeps) in paths.items():
            for dtype in ("bfloat16", "float32"):
                for init, bias in (("reference", cfg["flow_log_var_bias_init"]),
                                   ("near_identity", 0.0)):
                    del failed[:]
                    iaf_kernels.ADJ_SWEEPS_OVERRIDE = sweeps
                    with tempfile.TemporaryDirectory(prefix="chip_smoke_witness_") as run_dir:
                        r = _train_and_replay(torch, run_dir, nets(cfg, dtype, bias), 3, per_step,
                                              None, witness=True, fp64=path != "fast")
                    iaf_kernels.ADJ_SWEEPS_OVERRIDE = None
                    errs = r["card_vs_cpu"]["errors"]
                    emit("replay_witness", path=path, nets=dtype, init=init,
                         grad_rel=errs[0]["grad_rel"], grad_rel_param=errs[0]["grad_rel_param"],
                         **{k: v for k, v in errs[0].items() if "fp64" in k},
                         grad_norm_rel=[e["grad_norm"] for e in errs],
                         loss_rel=max(e[k] for e in errs for k in
                                      ("loss", "recon_loss", "kld_loss", "flow_loss")),
                         would_fail=list(failed))
        for dtype in ("bfloat16", "float32"):
            del failed[:]
            emit("trained_forward_witness", nets=dtype,
                 **_trained_forward_witness(torch, nets(default, dtype, -2.0)),
                 would_fail=list(failed))
    finally:
        check = gate
        iaf_kernels.ADJ_SWEEPS_OVERRIDE = None


def _trained_forward_witness(torch, model_config):
    """A default model trained 5 Trainer steps on the card at the native
    batches, its B=64 forward with ``model_config``'s nets against the CPU:
    compare_forward's errors, and compare_trained_forward's."""
    from rlvae_tpu_torch import ModelManager
    from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
    from rlvae_tpu_torch.models import create_model
    from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer

    cfg = copy.deepcopy(TRAINING_PRESETS["default"])
    cfg["data"]["batch_size"] = TRAIN_BATCH
    cfg["n_train_samples"], cfg["n_val_samples"] = TRAIN_STEPS * TRAIN_BATCH, TRAIN_BATCH
    data = CyclicDataModule({**CYCLIC_SPRITES, "synthetic_n_test": TRAIN_BATCH}, seed=0)
    data.setup(cfg)
    model = create_model(model_config, seed=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_witness_") as run_dir:
        Trainer(model, data, cfg, run_dir=run_dir, seed=0).fit(max_steps=TRAIN_STEPS)
    rng = np.random.default_rng(5)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, 16)), dtype=torch.float32)
    card = ModelManager(model, device=torch.device("cuda"))
    cpu = ModelManager(copy.deepcopy(model).to("cpu"), device="cpu")
    plain = compare_forward(torch, card.forward(seqs, eps=eps.cuda()), cpu.forward(seqs, eps=eps))
    return {"compare_forward": plain["errors"],
            "compare_trained_forward": compare_trained_forward(torch, card, cpu, seqs, eps)[0]}


if __name__ == "__main__":
    if sys.argv[1:] == ["--replay-witness"]:
        replay_witness()
    else:
        main()
