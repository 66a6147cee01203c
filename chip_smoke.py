#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``tpu_resnet_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the seconds ``nvcc`` took to build the kernels from
   ``tpu_resnet_torch/csrc`` (one compiler per source, started together);
   then a ``jpeg_libs`` line: which of ``nvjpeg.h``, ``libnvjpeg.so*`` and
   ``jpeglib.h`` the CUDA toolkit's and the system's include and library
   directories hold (what an ImageNet input pipeline could decode with).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at every shape the two serve paths give it with B=16 and the CIFAR train
   path gives it with B=128, in bfloat16 and float32 (float32 oracle with
   TF32 off): max abs/rel error against the stated tolerance; CUDA-event
   median times of kernel and plain version, on the device alone (``ms``:
   calls queued back to back behind a spin) and per call with the host's
   launch gaps (``call_ms``); the bound (bytes at 3.35 TB/s or float32
   operations at 67 TFLOP/s, the H100 SXM's published peaks); and for
   ``xent_fwd`` the time of ``F.cross_entropy(reduction="none")``
   (``library_ms``). ``block_fwd`` on the fused train path runs from the
   stats' c1 (``c1=``, one launch), kernel and plain version from the plain
   stats' c1, its bound one product with c1 read. ``sbr_bwd`` (one launch):
   dx exact, ds/db within 1e-5·Σ|g·mask·x| + 1e-6 per channel, two calls
   bit for bit equal; ``xent_fwd``/``xent_bwd`` at [128, 10/100/1000]
   within 1e-5 abs and rel, with int32 labels and a seeded cotangent (the
   timed call) and again with int64 labels and a broadcast cotangent
   (stride 0, the mean's). ``sbr`` is bit for bit its plain version
   (``torch.equal``) at every shape. First, ``launch_floor_ms``: the
   device time of one empty launch (``tr_noop``, 10 queued back to back
   behind the spin), and on the rows of ``sbr``, ``sbr_bwd``, ``xent_fwd``
   and ``xent_bwd`` ``floor_ms``, their launches times that floor: a
   pass takes at least the larger of ``bound_ms`` and ``floor_ms``. The
   fused block's training kernels
   (``block_stats``, ``block_bwd1``, ``block_bwd2``, ``block_bwd3``) at the
   three B=128 stage shapes, on inputs from a coarse dyadic grid (so
   conv1's output and the masks are exact in both): every sum within
   1e-5·Σ|terms| + 1e-6 per element, the stats' c1 and pass 1's dz2 and ẑ2
   within ``block_fwd``'s float32 tolerance, pass 2's dz1 and pass 3's dx
   within ``block_fwd``'s tolerance, two calls bit for bit equal, and
   ``block_fwd`` from the stats' own c1 bit for bit ``block_fwd`` from x
   (``block_bwd2`` fed the plain pass 1's dz2 and ẑ2, ``block_bwd3`` the
   plain pass 2's dz1); beside each ``block_bwd1`` row the elements where
   its mask [z2 > 0] differs from the plain pass's, read from its dz2, on
   the grid and on seeded normal inputs with the batch's own BN moments
   (``z2_mask_flips``: pass 1 computes c1 on the tensor cores, the plain
   pass in cuDNN's or PyTorch's own order). The same for the fused
   bottleneck's training kernels (``bottleneck_stats_a``,
   ``bottleneck_stats_b``, ``bottleneck_bwd1`` .. ``bottleneck_bwd4``) at
   the three ImageNet ResNet-50 stage shapes with B=128, dx within
   ``bottleneck_fwd``'s tolerance, the handed-over p2, mid, dm3, dmid and
   dc1 held like the sums, pass 1's masks [m2 > 0] and [m3 > 0] equal to
   the plain pass's (``bottleneck_bwd2`` fed the plain pass 1's p2, mid and
   dm3, ``bottleneck_bwd3`` the plain pass 2's dmid, ``bottleneck_bwd4``
   the plain pass 3's dc1; passes 1-3 and ``bottleneck_bwd`` time their
   weight-gradient products with them and say so, ``includes``); and
   ``bottleneck_wgrad`` (``wgrad.weight_grad``, the weight-gradient
   products of passes 1-3 and of ``bottleneck_bwd``, and of the fused
   block's passes at C = 128, 256) alone at the three stage shapes in
   each of its modes, dw3, dw2 and dw1 as the train step calls them (dw1
   on bfloat16 and float32 x) and the folded gradient's dW3 from p3, within
   1e-5·Σ|terms| + 1e-6 of the plain einsum or ``_wgrad``, two calls bit
   for bit equal, with ``library_ms``, one PyTorch call on the operand
   made beforehand (``torch.matmul(a.t(), b)``, or
   ``torch.nn.grad.conv2d_weight`` for dw2; TF32 off). The kernels on the
   tensor cores (``bottleneck_fwd``, the two moment passes, the four
   passes, ``bottleneck_wgrad``, ``block_fwd``, ``block_stats``,
   ``block_bwd1`` and ``block_bwd2``) also carry
   ``tc_bound_ms``, their
   operations at the TF32 tensor cores' rate over the three terms of the
   split. ``sbr``, ``sbr_bwd``, ``bottleneck_fwd`` and the cross-entropy
   pair also at the ImageNet train path's shapes. The fused block's kernels
   also at ImageNet ResNet-34's three fused stage shapes (56²x64, 28²x128,
   14²x256): ``block_fwd`` at B=16 (serve) and from the stats' c1 at B=128,
   ``block_stats`` and the three passes at B=128 (fewer timing
   repetitions), ``block_bwd`` at B=16, ``sbr``/``sbr_bwd`` at its 13 BN+ReLU
   sites; at C = 128 and 256 passes 1 and 2 and ``block_bwd`` time their
   weight gradients (``bottleneck_wgrad``'s shifted BN+ReLU mode) with
   them (``includes``), and ``bottleneck_wgrad`` has rows of its own for
   them at 28²x128 and 14²x256 (dw2 from ẑ2, dw1 from bfloat16 x).
   Then a ``nan`` line (fault 7): every kernel with a ReLU
   (``tools/nan_check.py``: ``sbr``, ``sbr_add``, the block's forward,
   stats and passes 1-2 at C = 64, 128, 256, the bottleneck's forward and
   first moment pass, the weight gradient's BN+ReLU operand) on inputs
   with NaNs at seeded places: NaN exactly where the plain version's
   output is, bit for bit its own clean output wherever the plain
   version's did not move; and the NaN drill (``NAN_DRILL``, graphed CIFAR
   ResNet-8, the step-5 batch NaN): rolled back from step 6 to checkpoint
   4, the reference's rollback.
3. ``serve`` (``cifar10``): CIFAR-10 ResNet-50 at full width (``--preset
   cifar10 model.fused_blocks=true model.fused_epilogue=on``) from seeded
   random weights, checkpointed to a temporary train dir and served by the
   port's ``PredictServer`` (buckets 1..16 warmed). Octet-stream and JSON
   requests are checked against the same model run through the plain
   versions on the card, and the launch counters, zeroed just before, must
   read 21 ``block_fwd`` and 7 ``sbr`` launches per forward pass.
4. ``serve`` (``imagenet``): ImageNet ResNet-50 at 224x224, full depth and
   width (``--preset imagenet model.fused_blocks=true
   model.fused_epilogue=on``), served the same way. The counters must read
   10 ``bottleneck_fwd``, 19 ``sbr`` and 0 ``block_fwd`` per forward pass.
   Logits are held against the plain-version model (max |d| within 5% of
   the largest |logit|), and the argmax must agree on every image whose
   plain-version top-1/top-2 margin exceeds twice the measured max |d|
   (random weights with 1000 classes leave many near-ties). Then
   ``imagenet34``: ImageNet ResNet-34 (``model.resnet_size=34``) served
   the same way: 10 ``block_fwd`` (2, 3, 5 at 56²x64, 28²x128, 14²x256)
   and 13 ``sbr`` per forward pass, the 7²x512 stage on F.conv2d.
   Then two ``serve_arms`` lines on the CIFAR and ImageNet ResNet-50
   checkpoints of these phases: (a) the ImageNet one frozen by
   ``export_from_checkpoint`` (``torch.export``, dynamic batch; seconds
   and artifact MB printed) and served by ``serve.backend=export`` with
   the serve phase's requests: the counters must read
   ``PER_PASS["imagenet"]`` per forward (the kernels run inside the
   artifact), the logits within ``LOGIT_TOL`` of the live checkpoint model
   through the plain versions, p50 at N=1 and N=16 and images/s printed;
   (c) that server's ``/metrics``: requests, images and batches as sent
   and batched, every serve series present, each histogram's count its
   samples; ``colocation_admission`` on the card (``mem_get_info``) must
   admit 1 GiB and deny twice the card. (b) CIFAR-10 ResNet-50 fused with
   ``serve.quantize=int8`` (calibrated on the synthetic eval split),
   served the same way: ``PER_PASS["cifar10"]`` per forward, the logits
   within ``LOGIT_TOL`` of the same int8 model through the plain versions,
   weight bytes at most ``ARMS_WEIGHT_RATIO`` of the float32 arm's, then
   exported quantized (the same digest and bytes in its manifest) and
   served from the artifact within ``LOGIT_TOL`` of the live int8 arm,
   its launches exact; the argmax agreement with the float32 twin is
   printed, not gated (random weights leave near-ties).
   Then two ``fleet`` lines: the serving fleet on the card. A seeded
   ImageNet ResNet-50 checkpoint (fused blocks and epilogue) in a train
   dir with a run id; ``python -m tpu_resnet_torch route`` (probe every
   ``FLEET_PROBE_S``, one failure opens a circuit) and ``fleetmon``
   (scrape every 0.5 s) started on it as processes of their own. (a) Two
   ``PredictServer``s in this process, r0 and r1, each with its discovery
   record; once the router holds both healthy, the counters zeroed and
   ``FLEET_REQUESTS`` seeded requests of 1 or 16 images at 224² sent
   through the router from ``FLEET_THREADS`` threads, the counters read:
   every answer 200, both replicas answering, ``PER_PASS["imagenet"]``
   launches times the forwards the replicas' ``/metrics`` report, the
   logits (``?logits=1``, forwarded by the router) within ``LOGIT_TOL``
   of the served model through the plain versions and the argmax on
   every clear-margin image; fleetmon's merged count equal to the
   replicas' own once a round has seen them, its merged p50/p99 beside
   each replica's own p99; the router and fleetmon map neither
   ``libcuda`` nor torch (``/proc/<pid>/maps``), and ``nvidia-smi
   --query-compute-apps`` does not list them where it lists this
   process. Its launches join the ``kernels`` line. (b) Two ``serve``
   processes on the card with the same checkpoint, r0 and r1, re-resolved
   by the router: they map ``libcuda`` (and ``nvidia-smi`` lists them
   where it lists this process); ``FLEET_EXACT`` sequential requests of
   16 images (one bucket) through the router bit for bit the in-process
   ``CheckpointBackend``'s kernel forward of the same batch; sequential
   HTTP latency at N=1 and N=16 straight to r0 and through the router
   (p50, p99); fleetmon's merged p99 beside each replica's own; then the
   port's loadgen, ``FLEET_LOAD`` closed-loop clients, ``replica_kill``
   (r0 SIGKILLed at half time): every request 200, r0 out of rotation
   within ``FLEET_EXCLUDE_S`` of its port refusing, the router's retries
   and the slowest request around the kill printed; ``route --drain r1``
   exits 0 and so does r1; SIGTERM: router and fleetmon exit 0;
   ``trace-export`` of the dir holds ``route_request``, ``route_drain``,
   ``replica_down``, ``serve_ready``, ``serve_drain`` and ``fleet_start``
   with the router's and the replicas' run ids the minted one.
   Then three ``autopilot`` lines: the fleet's control plane
   (``python -m tpu_resnet_torch autopilot``) and the port's supervisor
   (``python -m tpu_resnet_torch.tools.supervise``) on the card, with a
   seeded ImageNet ResNet-50 checkpoint. (a) r0, a ``serve`` process
   slowed by ``AP_SLOW_MS`` a batch (the serve fault), the router with
   watch-discovery probation, fleetmon and the autopilot (replicas 1..2,
   ``AP_SLO_MS``; its spawns ``serve`` processes of the same model under
   the supervisor): the port's loadgen's ``burst`` through the router
   (``AP_BURST``) makes the autopilot spawn ap0, which the router admits:
   every request 200, one spawn, two healthy replicas, the scale-up
   latency; ap0 maps ``libcuda`` and the port's kernel libraries, the
   autopilot and ap0's supervisor map neither ``libcuda`` nor torch;
   ``FLEET_EXACT`` B=16 requests straight to ap0 bit for bit the
   in-process ``CheckpointBackend``'s kernel forward of the same batches
   (19 ``sbr`` and 10 ``bottleneck_fwd`` a forward, counted); then
   ``AP_CALM`` (one closed-loop client): the autopilot drains ap0 through
   the router (its supervisor exits 0), ``capacity_lease.json`` granted to
   the trainer, ``autopilot_status.json`` at target 1 with one scale-up,
   one scale-down, one drain and no failed spawn, the ledger's spawn,
   drain and grant, the router's ``replica_admitted``, ``trace-export``'s
   autopilot lane under the minted run id; the burst's and calm's
   p50/p99, ``slo_violation_seconds``, ``replica_seconds`` and
   ``utilization``. (b) A second autopilot whose spawns carry
   ``serve.admission_hbm_bytes`` = a replica's measured footprint; the
   script takes card memory until less headroom than half that footprint
   is left once r0's is back, SIGKILLs r0: the floor's restore spawns at
   once, the spawn exits 3 (colocation admission denied) and its
   supervisor with it, unrestarted; one ``admission_denied``; the memory
   freed, the next spawn comes no sooner than ``AP_BACKOFF_S`` after the
   denial, is admitted and answers the same B=16 batches bit for bit;
   SIGTERM: autopilot, router and fleetmon exit 0 and the spawn drains.
   (c) The supervisor over ``train --preset cifar10`` fused, graphed, at
   full width (``AP_TRAIN``) with a preemption burst of 2 every
   ``AP_BURST_EVERY`` steps: children exit 42, 42, 0, the supervisor 0,
   the last checkpoint at step ``AP_TRAIN_STEPS``, the burst's state 2
   fired; every logged loss within ``AP_LOSS_RTOL`` relative of an
   uninterrupted in-process ``train()`` of the same steps, whose launches
   (``PER_PASS`` a step) join the ``kernels`` line. Each part's seconds.
5. ``train``: CIFAR-10 ResNet-50 at full width, B=128 (``--preset cifar10
   model.fused_epilogue=on optim.use_pallas_xent=on data.dataset=synthetic
   data.synthetic_learnable=true``): (a) one float32 train step from one
   seeded state through the kernels and one through the plain versions:
   loss, precision and grad_norm within 1e-5 relative, every updated
   parameter, momentum buffer and running statistic within 1e-5 + 1e-4·
   |plain|; (b) the port's ``train()`` for 100 steps in bfloat16 with a
   metrics line per step and a checkpoint every 50, the counters zeroed
   just before and read just after: 49 ``sbr``, 49 ``sbr_bwd``, 1
   ``xent_fwd`` and 1 ``xent_bwd`` launches per step and none of the fused
   blocks; every loss finite and the mean of the last 10 below the mean of
   the first 10 (``train()`` at the preset's ``train.steps_per_call=10``:
   with a log every step each chunk is one CUDA graph replay); (c)
   ``train()`` again to step 120, resuming from 100; (d)
   ``evaluate`` once on checkpoint 120 (49 ``sbr`` per eval forward),
   printing its precision and loss; then ms/step, images/s, device-busy ms
   per step and idle share of the loop's step under ``torch.profiler``.
6. ``train`` again, with ``model.fused_blocks=true`` (21 fused blocks, 7
   unfused BN+ReLU sites): the same (a)-(d), where (a) also runs the
   control, the plain versions on PyTorch's own convolutions instead of
   cuDNN's: the fused blocks sum their convolutions in another order, so
   backward masks recomputed from them flip near 0 and the step limits fail
   for any two implementations (the control too); (a) is reported against
   them and passes within ``CONTROL_FACTOR`` times the control's distance
   from the plain step (``compare_step``). The launch table per step: 21
   ``block_fwd``, 21 each of ``block_stats``, ``block_bwd1``,
   ``block_bwd2``, ``block_bwd3``, 7 ``sbr``, 7 ``sbr_bwd``, 1 ``xent_fwd``
   and 1 ``xent_bwd``; eval 21 ``block_fwd`` and 7 ``sbr`` per forward.
7. ``train`` for ImageNet ResNet-50 at 224x224, full depth and width,
   B=128 (``--preset imagenet model.fused_blocks=true
   model.fused_epilogue=on optim.use_pallas_xent=on``): (a) as in 6, at
   B=``IMAGENET_GATE_BATCH``; (b) the loop's own step (``build_state`` +
   ``make_loop_step``, as ``train()`` builds them; the step alone, without
   the input pipeline of 11) for ``IMAGENET_STEPS`` bfloat16 steps on a
   few seeded uint8 batches repeated, dispatched in chunks of the preset's
   ``train.steps_per_call`` CUDA graph replays (``ChunkRunner``, every
   step's metrics kept), the counters zeroed just before and read
   just after: 10 ``bottleneck_fwd``, 10 of each of the six bottleneck
   training kernels, 30 ``bottleneck_wgrad``, 19 ``sbr``, 19 ``sbr_bwd``,
   1 ``xent_fwd`` and 1 ``xent_bwd`` per step; every loss finite and the
   mean of the last 5 below the first 5's; (c) the eager step's profile
   (12 profiles the graphed one). Its eval is 11's. After 11, the same
   for ImageNet ResNet-34 fused (``imagenet34_fused_train``,
   ``model.resnet_size=34``): the f32 gate, 20 graphed steps with exactly
   10 ``block_fwd`` and 10 of each block training kernel, 16
   ``bottleneck_wgrad`` (dw2 and dw1 of the 8 blocks at 28²x128 and
   14²x256), 13 ``sbr`` + 13 ``sbr_bwd``, 1 + 1 xent per step; then its
   eager step profiled over ``IMAGENET34_PROFILE_STEPS`` steps with the
   peak device memory, beside the unfused ResNet-34 step's.

8. ``autotune``: (a) ``ep.probe_epilogue(include_add=True)`` in bfloat16 at
   every ``model_epilogue_shapes`` shape of the ``cifar10`` and
   ``imagenet`` presets with B=128 (3 and 11 shapes), the counters zeroed
   just before and read just after: ``sbr_add`` and ``sbr`` launched
   ``iters + 1`` times per shape, every decision with finite times and
   ``use_pallas == (speedup >= 1)``; (b) the slice's path, ``train
   --preset cifar10 data.dataset=synthetic data.synthetic_learnable=true
   model.fused_epilogue=auto`` on the preset's defaults
   (``optim.use_pallas_xent=auto``, ``data.device_resident=auto``) for
   ``AUTO_STEPS`` steps in a fresh train dir: the log names the
   device-resident input, ``autotune.json`` lists the three CIFAR shapes
   and ``xent|128x10``, the launches per step equal the BN sites whose
   shape chose the kernel (``sbr``, ``sbr_bwd``) and 1 or 0 of each xent
   kernel as chosen, the loss falls, and ``evaluate`` runs once.

9. ``ab``: the twins of the reference's A/B tools
   (``tpu_resnet_torch.tools.fused_block_ab`` and ``fused_bottleneck_ab``)
   through their per-shape functions, at the reference's shapes (B=128,
   the three CIFAR stages, the three ResNet-50 stages) and the block's at
   ImageNet ResNet-34's three fused stages (``imagenet34_ab``; two
   ``bottleneck_wgrad`` per ``block_bwd`` at C = 128, 256) in bfloat16: one
   ``fwd_bwd`` call of ``AB_LENGTH`` chained blocks per shape, the counters
   zeroed just before and read just after (``AB_LENGTH`` launches of
   ``block_fwd`` and ``block_bwd``, or of ``bottleneck_fwd`` and
   ``bottleneck_bwd`` and three times as many of ``bottleneck_wgrad``, and
   nothing else); then the four arms' µs per block
   and speedups (``run_shape``, ``AB_REPS`` timed calls per arm).
10. ``grad``: the gradient, in the input images and every parameter, of an
   eval-mode fused model on seeded weights (BN moved off its init), float32,
   B=``GRAD_BATCH``: CIFAR-10 ResNet-50 and ImageNet ResNet-50 at 224x224
   (``--preset cifar10|imagenet model.fused_blocks=true
   model.fused_epilogue=on``). Through the kernels against the plain
   versions, normwise per tensor: the worst within ``GRAD_RTOL``'s floor
   or ``CONTROL_FACTOR`` times the control's worst (the plain versions on
   PyTorch's own convolutions), never beyond its ceiling; the counters
   read one forward and its backward: 21 ``block_fwd`` + 7 ``sbr`` + 21
   ``block_bwd`` + 7 ``sbr_bwd`` (CIFAR), 10 ``bottleneck_fwd`` + 19
   ``sbr`` + 10 ``bottleneck_bwd`` + 30 ``bottleneck_wgrad`` + 19
   ``sbr_bwd`` (ImageNet).
11. ``imagenet_input``, after 7: ImageNet ResNet-50 training and eval from
   JPEG shards through the port's input pipeline (``--preset imagenet
   model.fused_blocks=true model.fused_epilogue=on optim.use_pallas_xent=on
   train.global_batch_size=128 data.data_dir=<shards>``). The shards are
   made at run time from the 28 committed fixture JPEGs
   (``tests/fixtures/imagenet``, 113 kB each on average, about ImageNet's
   mean) with seeded labels 1..1000: 8 train shards
   of 160 records, one validation shard of 250. (a) The decode stage on one
   B=128 order of the train stream: nvJPEG against the plain decoder per
   sampling (``NVJPEG_TOL``), nvJPEG + ``tr_resize_crop`` against the plain
   decoder + the plain resize (``STAGE_TOL``), ``tr_resize_crop`` alone
   against its plain version on nvJPEG's pixels (``RESIZE_TOL``, one launch
   a batch), its times and bound, nvJPEG's ms per batch and its bytes
   bound, the plain decoder's ms on the host and the stage's images/s on
   one thread. (b) ``train()`` for ``INPUT_STEPS`` steps, the
   counters zeroed just before and read just after: the ImageNet step's
   launches exactly (7's table) and one ``tr_resize_crop`` a decoded batch;
   finite losses; every batch copied to the host after its step and held
   bit for bit against a synchronous decode of its order. (c) A second run resumed from step ``INPUT_RESUME_AT``'s
   checkpoint: its first batch bit for bit the first run's. (d)
   ``evaluate`` once: exactly 250 records, 10 ``bottleneck_fwd`` + 19
   ``sbr`` per forward, one ``tr_resize_crop`` a batch. (e) The step fed
   by a fresh engine in its steady state: once the step has drained the
   engine's ring (at most ``INPUT_SETTLE_MAX`` steps), ``profile_train_step``
   over ``INPUT_PROFILE_STEPS`` steps, as 7's seeded-batch step: wall,
   images/s, the step's streams' busy time and idle share, the decode
   streams' time (copies included) and the device's idle share over all
   streams, and the ring's decoded batches at the window's start and end.
12. ``chunked_train``, after 11: multi-step dispatch. Per path (CIFAR-10
   ResNet-50 unfused and fused, ImageNet ResNet-50 at 224x224 fed seeded
   batches on the card in the decode engine's place; B=128, bf16),
   ``train()`` three times from the same seeded state over the same steps
   (``CHUNK_PATHS``: 50 steps, log and checkpoint every 25; ImageNet 30,
   a log every 10): ``train.steps_per_call=1`` twice (eager; the second is
   the control) and ``=10`` (CUDA graph replays). The graphed run's end
   state (parameters, BN statistics, momentum buffers) and logged metrics
   bit for bit the eager run's where the control is, else within
   ``CONTROL_FACTOR`` times the control's normwise distance; launches
   exactly ``PER_PASS`` a step in every run; the same ``metrics.jsonl``
   steps and checkpoints. Per run: loop ms/step and images/s over the
   steps after the first log interval, the capture's seconds, peak device
   memory, and (not the control) its dispatch profiled on its end state
   (busy, idle share); ``sbr_bwd``'s capture-stream tickets zero after the
   replays; over the fused path's graphed profile the counters against
   the profiler's kernel counts a step (reported, not gated). Then the fused path streamed from
   the host (``data.device_resident=off``, graphed) at
   ``data.transfer_stage=8`` with the double buffer on and off and at 1:
   every batch the steps read and the loss stream bit for bit equal across
   the three, the h2d stats printed; and whether ``torch.optim.SGD`` with
   a tensor learning rate can be captured (a process of its own).
13. ``observability``, after 12: per path of ``OBS_PATHS`` (ImageNet
   ResNet-50 fused on seeded batches on the card, 30 steps; CIFAR-10
   ResNet-50 fused, 100 steps; B=128, graphed at ``steps_per_call=10``),
   ``train()`` with observability on
   (``train.telemetry_port=0``, the FLOPs and memory ledgers, the
   watchdog at ``OBS_WATCHDOG_SEC``), ``/metrics`` and ``/healthz``
   scraped from a thread every 50 ms while it runs, the counters zeroed
   just before and read just after (launches exactly ``PER_PASS`` a
   step): ``step``, ``images_per_sec``, ``mfu``, ``model_flops_per_sec``
   and the ``hbm_bytes_*`` gauges present and finite; ``mfu`` (logged and
   scraped) equal to ``flops.json``'s count × steps/s ÷ the card's peak
   to ``MFU_RTOL``; ``memory.json``'s peak within ``MEMORY_RTOL`` of
   ``torch.cuda.max_memory_allocated()`` over the run; ``events.jsonl``
   parsed. The same run with observability off: end state and
   loss/precision bit for bit, both runs' loop ms/step and their
   difference (reported); the ImageNet run's launches join the
   ``kernels`` line. Then the drills on CIFAR-10 ResNet-50 fused,
   graphed, at full depth: a ``DRILL_STALL`` data stall on the streamed
   path against a 1 s watchdog (one stack dump, /healthz 200 → 503 → 200,
   the two watchdog spans); SIGTERM at step ``DRILL_SIGTERM_AT``
   (``Preempted`` there, its checkpoint, the resumed run bit for bit the
   uninterrupted one, else within ``CONTROL_FACTOR`` times a control's
   distance); the uninterrupted run's newest checkpoint corrupted
   (``resilience.inject_corrupt_ckpt``: the restore falls back to the one
   before); a synthetic RESOURCE_EXHAUSTED at step 20 (an
   ``oom_report.json`` that ``validate_oom_report`` passes, with the
   allocator's stats).

Each phase line carries ``elapsed_s``, the seconds since the script
started.

The ``kernels`` phase also holds ``sbr_add`` (``tr_sbr_add``) against its
plain version at the 14 probe shapes, bfloat16 and float32: the forward
bit for bit, and through autograd dx bit for bit, dr == g, ds/db within
``sbr_bwd``'s limits; and the folded blocks' gradients, ``block_bwd`` at
the three CIFAR and the three ImageNet ResNet-34 B=128 stage shapes (the
A/B tool's) and ``bottleneck_bwd`` at the three ResNet-50 B=128 stage
shapes, bfloat16 and float32, on the dyadic grids of the training kernels,
and again at the grad phase's B=``GRAD_BATCH`` shapes: every sum and weight gradient within 1e-5·Σ|terms| + 1e-6, dx
within ``block_fwd``'s or ``bottleneck_fwd``'s tolerance, two calls bit for
bit equal, and no mask of the first step ([a2 > 0], [m3 > 0], read from
the dc1 or dmid it hands over) other than the plain version's
(``mask_flips``).

Four ``data_parallel`` lines, after ``cli``: the port's data parallelism
(``parallel/``) on the card, with a process group opened and ranks
spawned (``torch.multiprocessing``, ``spawn``) by the script. (a) the
fused CIFAR path of ``chunked_train`` (chunks of 10 graph replays) with
an NCCL group of one rank open, whose step all-reduces its gradients
inside the graph, against that phase's graphed run without a group: bit
for bit the same run, the same launches a step, each run's loop ms a
step. (b) two gloo ranks sharing the card (NCCL refuses two ranks on one
card; gloo runs eager), 64 of the 128 rows each, the fused per-replica
step (``model.sync_bn=false``): ``compare_step``'s float32 gate (kernels
against plain versions, 4x the control), its launches equal to the
one-card step's table, and the eager bfloat16 rank step's median ms.
(c) on the same ranks, synced BN unfused: the 2-rank step against the
1-rank step on the whole batch within the step limits or 4x the control
(the 1-rank step on PyTorch's own convolutions), and zero1 against
replicated at 2 ranks within ``ZERO1_TOL``. Then the ranks' ``train()``
runs (``DP_TRAIN_RUNS``, resident data, eager): (b)'s fused per-replica
20 steps, and (c)'s synced zero1 in float32, 2 steps, each with one
checkpoint: both ranks end bit for bit equal, the run directory holds
what a 1-rank run writes and one metrics record per logged step (rank 0
alone wrote), (b)'s launches per rank the one-card table a step, and
(c)'s run normwise within 4x its control of the 1-rank ``train()``
(the control: that run on the plain versions and PyTorch's own
convolutions). (d) two NCCL ranks on two cards where the machine has
them, else the line ``{"data_parallel_nccl_2": "not run: 1 card"}``.

A ``cli`` line: the port's run tools through ``python -m tpu_resnet_torch``
on the card. ``doctor --probe-timeout 60`` with every check ok (an H100 of
capability 9.0, nvcc, every kernel library built, the empty launch
made); ``info --preset imagenet`` printing 25,549,352 parameters; the
graphed fused CIFAR ``train()`` (chunks of 10, 30 steps) unprofiled and
with ``train.profile_steps`` 10:20 and 0:10 (warm-up and capture inside
the window), the profiled runs' losses, end state and checkpoints bit for
bit the unprofiled run's, launches exact; ``trace-export --device-trace``
on each profiled dir, every kernel the counters saw named in the merged
device lanes, every device event inside the ``profiler_trace`` span, the
profiler's launches of each beside the counters'; the window's device
busy time, idle share, idle gaps by size with the launches on either side
of the longest, and the most frequent launch names; ``inspect`` on the
checkpoint and ``plot --csv`` (its CSV; the PNG where matplotlib is
installed).

Then one ``{"kernels": [...]}`` line of the 20 kernels (times summed over
the launches of one forward pass of each serve path and one train step that
run the kernel, in bfloat16; for ``sbr_add`` over one call at each probe
shape, for ``block_bwd`` and ``bottleneck_bwd`` over one call at each A/B
shape, and per path also over one backward of the grad phase;
``launches`` is the count over the phases that drive the main paths:
both serve phases, both serve arms and the fleet's in-process replicas
(part (a)), the autopilot phase's uninterrupted fused CIFAR run (part
(c)), the train and eval runs of both
CIFAR train phases, the
ImageNet train steps, the JPEG-fed ImageNet train, resume and eval runs,
the observability phase's ImageNet run with observability on,
both parts of the autotune phase, the ``ab`` phase's counted calls and the
``grad`` phase) and, last, ``resize_crop`` (phase 11's B=128 batch; its
launches over the train, resume and eval runs; ``library_ms`` null: no
one PyTorch call takes the same window and rounding),
the ``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero before the last line;
without CUDA the script exits 2.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

# The port beside this script, however Python was started (``-I``, or from
# another directory).
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tpu_resnet_torch.ops import fused_block as _fb  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# The three-term TF32 split (csrc/mma_tf32x3.cuh) issues three tensor-core
# products per float32 product: 495 TFLOP/s of TF32 over three.
TF32X3_FLOP_PER_S = 495e12 / 3
BATCH = 16
TRAIN_BATCH = 128


def imagenet_shapes(b: int) -> dict:
    """ImageNet ResNet-50 at 224x224, batch b: (shape, launches per forward
    pass or train step) of ``sbr`` (19 BN+ReLU sites: 6 unfused blocks and
    the final one) and of ``bottleneck_fwd`` (the 10 stride-1 identity
    bottlenecks of width 64/128/256)."""
    return {"sbr": (((b, 56, 56, 64), 3), ((b, 56, 56, 256), 1),
                    ((b, 56, 56, 128), 1), ((b, 28, 28, 128), 1),
                    ((b, 28, 28, 512), 1), ((b, 28, 28, 256), 1),
                    ((b, 14, 14, 256), 1), ((b, 14, 14, 1024), 1),
                    ((b, 14, 14, 512), 1), ((b, 7, 7, 512), 5),
                    ((b, 7, 7, 2048), 3)),
            "bottleneck_fwd": (((b, 56, 56, 256), 2), ((b, 28, 28, 512), 3),
                               ((b, 14, 14, 1024), 5))}


def imagenet34_shapes(b: int) -> dict:
    """ImageNet ResNet-34 at 224x224 with ``model.fused_blocks=true``,
    batch b: (shape, launches per forward pass or train step) of ``sbr``
    (13 BN+ReLU sites: the four block0s, the 7²x512 stage's two unfused
    blocks and the final one) and of ``block_fwd`` (the 10 stride-1
    identity blocks the reference fuses: 2, 3 and 5 of the 56²x64, 28²x128
    and 14²x256 stages; the 7²x512 stage stays on F.conv2d)."""
    return {"sbr": (((b, 56, 56, 64), 3), ((b, 28, 28, 128), 2),
                    ((b, 14, 14, 256), 2), ((b, 7, 7, 512), 6)),
            "block_fwd": (((b, 56, 56, 64), 2), ((b, 28, 28, 128), 3),
                          ((b, 14, 14, 256), 5))}


# (shape, launches per forward pass) on each serve path, at B=BATCH, and
# per step on the train paths, at B=TRAIN_BATCH.
TRAIN_SBR = (((TRAIN_BATCH, 32, 32, 16), 17), ((TRAIN_BATCH, 16, 16, 32), 16),
             ((TRAIN_BATCH, 8, 8, 64), 16))
SHAPES = {
    "cifar10": {
        "sbr": (((BATCH, 32, 32, 16), 3), ((BATCH, 16, 16, 32), 2),
                ((BATCH, 8, 8, 64), 2)),
        "block_fwd": (((BATCH, 32, 32, 16), 7), ((BATCH, 16, 16, 32), 7),
                      ((BATCH, 8, 8, 64), 7)),
    },
    "imagenet": imagenet_shapes(BATCH),
    "cifar10_train": {"sbr": TRAIN_SBR},
    # model.fused_blocks=true: 7 fused blocks per stage, B=TRAIN_BATCH.
    "cifar10_fused_train": {"block_fwd": (((TRAIN_BATCH, 32, 32, 16), 7),
                                          ((TRAIN_BATCH, 16, 16, 32), 7),
                                          ((TRAIN_BATCH, 8, 8, 64), 7))},
    # ImageNet ResNet-50 training through the 10 fused bottlenecks.
    "imagenet_fused_train": imagenet_shapes(TRAIN_BATCH),
    # ImageNet ResNet-34: served, and trained through its 10 fused blocks.
    "imagenet34": imagenet34_shapes(BATCH),
    "imagenet34_fused_train": imagenet34_shapes(TRAIN_BATCH),
}
# The fused train paths of the basic block, whose block_fwd runs from the
# stats' c1, and the block kernels' widths that take their weight gradients
# from bottleneck_wgrad (two calls a step per block: dw2 in pass 1, dw1 in
# pass 2).
BLOCK_TRAIN_PATHS = ("cifar10_fused_train", "imagenet34_fused_train")
WIDE_CHANNELS = tuple(c for c in _fb.CHANNELS if c not in _fb.TAP_CHANNELS)
# Train-path kernels with their own rows: sbr_bwd at the train paths' sbr
# shapes, the cross-entropy pair at these (path, class count, launches per
# step), the fused block's training kernels at the block_fwd shapes of the
# fused CIFAR train path, the fused bottleneck's at the bottleneck_fwd
# shapes of the ImageNet train path.
XENT_CLASSES = (("cifar10_train", 10, 1), ("cifar10_train", 100, 0),
                ("imagenet_fused_train", 1000, 1),
                ("imagenet34_fused_train", 1000, 1))
BLOCK_TRAIN = ("block_stats", "block_bwd1", "block_bwd2", "block_bwd3")
BOTTLENECK_TRAIN = ("bottleneck_stats_a", "bottleneck_stats_b",
                    "bottleneck_bwd1", "bottleneck_bwd2", "bottleneck_bwd3",
                    "bottleneck_bwd4")
KERNELS = ("sbr", "block_fwd", "bottleneck_fwd", "sbr_bwd", "xent_fwd",
           "xent_bwd", *BLOCK_TRAIN, *BOTTLENECK_TRAIN, "sbr_add",
           "block_bwd", "bottleneck_bwd", "bottleneck_wgrad")
# Launches per forward pass of each serve path and per train step, every
# kernel listed.
PER_PASS = {path: {k: sum(n for _, n in shapes.get(k, ()))
                   for k in KERNELS}
            for path, shapes in SHAPES.items()}
PER_PASS["cifar10_train"].update(
    sbr_bwd=sum(n for _, n in TRAIN_SBR), xent_fwd=1, xent_bwd=1)
# The fused train step keeps 7 unfused BN+ReLU sites (two per block0, the
# final one), as the CIFAR serve forward does. The counters count wrapper
# calls: on the card block_fwd from the stats' c1 (the train step) and
# block_bwd3 are one launch each, block_fwd from x (serving, eval,
# block_apply; r2, then conv2 and the residual), block_stats (c1 and the
# tiles' sums, their sum) and block_bwd1 (the tile pass, the sum of its
# rows) two, block_bwd2 three (dc1, dz1 and the sums, their sum), the
# folded block_bwd four (two steps of a tile pass and the sum of its rows);
# sbr_bwd is one launch everywhere.
PER_PASS["cifar10_fused_train"].update(
    sbr=7, sbr_bwd=7, xent_fwd=1, xent_bwd=1,
    **{k: PER_PASS["cifar10_fused_train"]["block_fwd"] for k in BLOCK_TRAIN})
# The ImageNet train step: each fused bottleneck runs bottleneck_fwd and the
# six training kernels once, and passes 1-3 one weight gradient each; the
# 19 sbr sites each run sbr_bwd.
PER_PASS["imagenet_fused_train"].update(
    sbr_bwd=PER_PASS["imagenet_fused_train"]["sbr"], xent_fwd=1, xent_bwd=1,
    bottleneck_wgrad=3 * PER_PASS["imagenet_fused_train"]["bottleneck_fwd"],
    **{k: PER_PASS["imagenet_fused_train"]["bottleneck_fwd"]
       for k in BOTTLENECK_TRAIN})
# The ImageNet ResNet-34 train step: each fused block runs block_fwd (from
# the stats' c1) and the four training kernels once; at 28²x128 and
# 14²x256 passes 1 and 2 each take one bottleneck_wgrad call (8 blocks);
# the 13 sbr sites each run sbr_bwd.
PER_PASS["imagenet34_fused_train"].update(
    sbr_bwd=PER_PASS["imagenet34_fused_train"]["sbr"], xent_fwd=1,
    xent_bwd=1,
    bottleneck_wgrad=2 * sum(n for shape, n in SHAPES[
        "imagenet34_fused_train"]["block_fwd"]
        if shape[-1] in WIDE_CHANNELS),
    **{k: PER_PASS["imagenet34_fused_train"]["block_fwd"]
       for k in BLOCK_TRAIN})
TRAIN_OVERRIDES = ["model.fused_epilogue=on", "optim.use_pallas_xent=on",
                   "data.dataset=synthetic", "data.synthetic_learnable=true"]
# Each train path: its overrides and the launches of one eval forward.
TRAIN_PATHS = {
    "cifar10_train": {"overrides": [], "label": "fused_blocks=off",
                      "eval_per_forward": {"sbr": 49}},
    "cifar10_fused_train": {"overrides": ["model.fused_blocks=true"],
                            "label": "fused_blocks=on",
                            "eval_per_forward": PER_PASS["cifar10"]},
}
TRAIN_STEPS, RESUME_STEPS = 100, 120
# Steps each profiled train step's host clock and profiler take (the
# profiler's events take the host seconds to read).
TRAIN_PROFILE_STEPS = 10
# The ImageNet train phase: the loop's step on a fixed set of seeded uint8
# 224x224 batches, repeated; the float32 step gate at IMAGENET_GATE_BATCH.
IMAGENET_OVERRIDES = ["model.fused_blocks=true", "model.fused_epilogue=on",
                      "optim.use_pallas_xent=on"]
IMAGENET_STEPS, IMAGENET_BATCHES, IMAGENET_GATE_BATCH = 20, 2, 32
# The ImageNet train paths: ResNet-50 through its fused bottlenecks, and
# ResNet-34 through its fused basic blocks, whose step is also profiled
# unfused (model.fused_blocks=false) beside it, IMAGENET34_PROFILE_STEPS
# steps each.
IMAGENET_TRAIN_PATHS = {
    "imagenet_fused_train": {"resnet_size": 50, "overrides": []},
    "imagenet34_fused_train": {"resnet_size": 34,
                               "overrides": ["model.resnet_size=34"]}}
IMAGENET34_PROFILE_STEPS = 5
# The autotune phase: the probe's timed calls per arm, and the steps of the
# slice's own train path (model.fused_epilogue=auto on the cifar10
# preset's defaults).
PROBE_ITERS, AUTO_STEPS = 30, 30
AUTO_OVERRIDES = ["data.dataset=synthetic", "data.synthetic_learnable=true",
                  "model.fused_epilogue=auto"]
# The A/B phase: blocks chained per call and timed calls per arm.
AB_LENGTH, AB_REPS = 2, 2
# The eval-mode gradient phase: each preset's fused model in float32, and
# the launches of one forward and its backward.
GRAD_BATCH = 16
GRAD_OVERRIDES = ["model.fused_blocks=true", "model.fused_epilogue=on",
                  "model.compute_dtype=float32"]
# The grad phase's block_bwd and bottleneck_bwd shapes, with their launches
# per backward.
GRAD_SHAPES = {
    "cifar10": (((GRAD_BATCH, 32, 32, 16), 7), ((GRAD_BATCH, 16, 16, 32), 7),
                ((GRAD_BATCH, 8, 8, 64), 7)),
    "imagenet": imagenet_shapes(GRAD_BATCH)["bottleneck_fwd"],
    # The eval-mode gradient of ImageNet ResNet-34's fused blocks.
    "imagenet34": imagenet34_shapes(GRAD_BATCH)["block_fwd"]}
# The gradient's gate, normwise per tensor: the floor, and the ceiling
# that CONTROL_FACTOR times the control's distance may not pass.
GRAD_RTOL = (1e-3, 1e-2)
GRAD_PER_BACKWARD = {
    "cifar10": {"block_fwd": 21, "sbr": 7, "block_bwd": 21, "sbr_bwd": 7},
    "imagenet": {"bottleneck_fwd": 10, "sbr": 19, "bottleneck_bwd": 10,
                 "bottleneck_wgrad": 30, "sbr_bwd": 19}}
# |kernel - plain| <= atol + rtol * |plain|, elementwise. sbr rounds
# exactly as the plain version does, and is held to torch.equal; the fused
# blocks sum their convs in another order than cuDNN/cuBLAS, and in
# bfloat16 that can move the stored value by an ulp (2^-8 relative).
TOLERANCE = {
    ("sbr", torch.float32): (0.0, 0.0),
    ("sbr", torch.bfloat16): (0.0, 0.0),
    ("block_fwd", torch.float32): (1e-4, 1e-4),
    ("block_fwd", torch.bfloat16): (1e-2, 1e-2),
    ("bottleneck_fwd", torch.float32): (1e-4, 1e-4),
    ("bottleneck_fwd", torch.bfloat16): (1e-2, 1e-2),
}
# Served logits against the plain-version model: bfloat16 activations
# through 50 layers, where one-ulp differences compound.
LOGIT_TOL = 0.05   # max |d| as a fraction of max |plain logit|
ARGMAX_AGREE = 0.99
# sbr_bwd's ds/db and every sum of the fused block's training kernels:
# |kernel - plain| <= rtol * sum|terms| + atol per element (float32 sums over
# B*H*W pixels, in another order); sbr_bwd's dx is exact, block_bwd3's dx is
# held to block_fwd's tolerance.
SBR_BWD_TOL = (1e-5, 1e-6)
XENT_TOL = (1e-5, 1e-5)    # xent_fwd/xent_bwd, atol and rtol
# The kernels whose rows carry floor_ms: one launch a call each.
FLOOR_KERNELS = ("sbr", "sbr_bwd", "xent_fwd", "xent_bwd")
# The float32 train step through the kernels against the plain versions:
# metrics within STEP_RTOL relative, state within atol + rtol * |plain|.
STEP_RTOL = 1e-5
STATE_TOL = (1e-5, 1e-4)
# Where the kernels replace convolutions: the kernels' step within this
# factor of the control's distance (compare_step).
CONTROL_FACTOR = 4.0


# The script's start, for each phase line's ``elapsed_s``.
STARTED = time.monotonic()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.monotonic() - STARTED}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, queued: bool, reps: int = 10, inner: int = 10,
            warmup: int = 3) -> float:
    """CUDA-event median of ``reps`` runs of ``inner`` calls, per call,
    after ``warmup`` calls.

    ``queued``: the calls are enqueued behind a ~10 ms device spin, so they
    run back to back and the events time the device alone; otherwise the
    events also take in the host's launch gaps (wrapper checks, ctypes,
    PyTorch dispatch), which dominate a kernel shorter than its launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def launch_floor_ms() -> float:
    """The device time of one empty launch (``tr_noop``, which replaces no
    TPU kernel), queued back to back behind the spin as every row's calls
    are: the least time any one-launch call takes."""
    from tpu_resnet_torch.ops import _build
    lib = _build.library("epilogue")
    stream = torch.cuda.current_stream().cuda_stream

    def noop():
        _build.check(lib.tr_noop(torch.cuda.current_device(), stream),
                     "tr_noop")
    return time_ms(noop, queued=True, inner=10)


def bound(kind: str, shape, dtype, flop_per_s: float = F32_FLOP_PER_S
          ) -> tuple:
    """(least ms the card could take, what bounds it): each input read
    once, each output written once, operations at ``flop_per_s`` (the
    float32 rate unless given)."""
    item = torch.tensor([], dtype=dtype).element_size()
    if kind in ("xent_fwd", "xent_bwd"):
        b, c = shape
        if kind == "xent_fwd":   # logits, labels in; loss out
            moved = b * c * 4 + 2 * b * 4
            ops = 4 * b * c + 3 * b   # max, sub, exp, add; log, add, sub
        else:                    # logits, labels, g in; dx out
            moved = 2 * b * c * 4 + 2 * b * 4
            ops = 8 * b * c           # max, sub, exp, add; sub, exp, div..
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / flop_per_s
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")
    b, h, w, c = shape
    n = b * h * w * c
    if kind == "sbr":
        moved = 2 * n * item + 2 * c * 4
        ops = 3 * n                                  # mul, add, max
    elif kind == "sbr_add":   # x, r in, y out; s, b in
        moved = 3 * n * item + 2 * c * 4
        ops = 4 * n                                  # mul, add, max, add
    elif kind == "sbr_bwd":   # x, g in, dx out; s, b in, ds, db out
        moved = 3 * n * item + 4 * c * 4
        ops = 8 * n   # mul, add, compare; mul (dx); mul, add (ds); add (db)
    elif kind == "block_fwd":
        # x in, y out, the weights and folds in, and r2 ([B,H,W,C] float32,
        # 4n bytes) written by the first launch and read by the second.
        moved = 2 * n * item + 2 * 4 * n + 2 * 9 * c * c * 4 + 4 * c * 4
        ops = 2 * (2 * b * h * w * 9 * c * c) + 6 * n
    elif kind == "block_fwd_c1":
        # The training forward from the stats' c1: x and c1 (float32) in, y
        # out, w2 and the folds s2, b2 in; conv2 and BN2's scale, bias, ReLU
        # and the residual add.
        moved = 2 * n * item + 4 * n + 9 * c * c * 4 + 2 * c * 4
        ops = 2 * b * h * w * 9 * c * c + 4 * n
    elif kind in BLOCK_TRAIN:
        # x in, weights and BN vectors in, the sums out; then the float32
        # tensors (4n bytes is one float a pixel-channel): the stats' c1
        # out; pass 1's gy in,
        # its dz2 and ẑ2 out; pass 2's dz2 and ẑ2 in, its dc1 written and
        # read between its launches and its dz1 out; pass 3's gy and dz1
        # in; pass 3's dx out. Operations: the 3x3 products (one for the
        # stats, three for pass 1: c1, the convT of gy, dw2; two for pass 2:
        # the convT of dc1, dw1), 2*B*H*W*9*C*C flops each; pass 3 runs
        # none (dx from dz1: bytes).
        products, vecs, weights, moved_f32 = {
            "block_stats": (1, 2, 1, 4 * n),
            "block_bwd1": (3, 8, 2, 3 * 4 * n),
            "block_bwd2": (2, 8, 1, 5 * 4 * n),
            "block_bwd3": (0, 5, 0, 2 * 4 * n)}[kind]
        sums = {"block_stats": 2 * c, "block_bwd1": 2 * c + 9 * c * c,
                "block_bwd2": 2 * c + 9 * c * c, "block_bwd3": 0}[kind]
        moved = (n * item + moved_f32
                 + (weights * 9 * c * c + vecs * c + sums) * 4
                 + (n * item if kind == "block_bwd3" else 0))
        ops = products * 2 * b * h * w * 9 * c * c
    elif kind in BOTTLENECK_TRAIN:   # c = 4f; centre rows only
        f = c // 4
        ff = f * f
        # flops per pixel; floats of weights (w1 4f², w2 9f², w3 4f²), of
        # BN vectors and correction sums in, and of sums and weight
        # gradients out; x in, then the float32 tensors: gy, and the
        # [B,H,W,f] tensors handed over (n bytes is f floats a pixel:
        # stats_b's first launch writes p2, its second reads it; bwd1
        # writes p2, mid, dm3; bwd2 reads them and writes dmid; bwd3 reads
        # dmid, writes dc1; bwd4 reads dc1 and gy), and dx out. bwd1: c1
        # 8f², mid 18f², gy·W3ᵀ 8f², dw3 8f²; bwd2: c1, convT 18f², dw2
        # 18f²; bwd3: c1, convT, dc1·W1ᵀ 8f², dw1 8f²; bwd4: dc1·W1ᵀ.
        flops, weights, vecs, sums, moved_f32 = {
            "bottleneck_stats_a": (8 * ff, 4 * ff, 4 * c, 2 * f, 0),
            "bottleneck_stats_b": (26 * ff, 13 * ff, 4 * c + 4 * f, 2 * f,
                                   2 * n),
            "bottleneck_bwd1": (42 * ff, 17 * ff, 4 * c + 8 * f,
                                2 * f + 4 * ff, 4 * n + 3 * n),
            "bottleneck_bwd2": (44 * ff, 13 * ff, 4 * c + 9 * f,
                                2 * f + 9 * ff, 3 * n + n),
            "bottleneck_bwd3": (42 * ff, 13 * ff, 4 * c + 6 * f,
                                2 * c + 4 * ff, 2 * n),
            "bottleneck_bwd4": (8 * ff, 4 * ff, 6 * c, 0, 4 * n + n)}[kind]
        moved = (n * item + moved_f32 + (weights + vecs + sums) * 4
                 + (n * item if kind == "bottleneck_bwd4" else 0))
        ops = flops * b * h * w
    elif kind == "block_bwd":
        # x, gy (float32) in, dx out; dc1 ([B,H,W,C] float32, 4n bytes)
        # written by step 1 and read by step 2; w1, w2 and the four folded
        # vectors in, dw1, dw2 and the four sums out; five 3x3 products (the
        # c1 recompute, two convT, dw1, dw2), the reference's work.
        moved = 2 * n * item + 4 * n + 2 * 4 * n + (4 * 9 * c * c + 8 * c) * 4
        ops = 5 * 2 * b * h * w * 9 * c * c
    elif kind == "bottleneck_bwd":   # c = 4f
        # x, gy (float32) in, dx out; the [B,H,W,f] float32 tensors handed
        # over (n bytes each: p2, c1, p3, dmid, dc1), each written once and
        # read once; the three weights (17f² floats) and six folded vectors
        # in, their gradients out; 94f² flops per pixel (c1 8, mid 18,
        # gy·W3ᵀ 8, convT 18, dc1·W1ᵀ 8, dW1 8, dW3 8, dw2 18), the
        # reference's work.
        f = c // 4
        moved = (2 * n * item + 4 * n + 5 * 2 * n
                 + (2 * 17 * f * f + 4 * (c + 2 * f)) * 4)
        ops = 94 * f * f * b * h * w
    else:   # bottleneck_fwd: c = 4f
        f = c // 4
        # x in, y out, the weights and folds in, and p2 ([B,H,W,f] float32,
        # n bytes) written by the first launch and read by the second.
        moved = (2 * n * item + 2 * n
                 + (2 * c * f + 9 * f * f + 2 * c + 4 * f) * 4)
        # 1x1 reduce, 3x3, 1x1 expand; three scale-bias-ReLUs; residual add
        ops = 2 * b * h * w * (2 * c * f + 9 * f * f) + b * h * w * (
            3 * (c + 2 * f) + c)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / flop_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# The kernels whose products run on the tensor cores (three-term TF32).
TENSOR_CORE_KERNELS = ("bottleneck_fwd", "bottleneck_stats_a",
                       "bottleneck_stats_b", "bottleneck_bwd1",
                       "bottleneck_bwd2", "bottleneck_bwd3",
                       "bottleneck_bwd4", "bottleneck_wgrad", "block_fwd",
                       "block_stats", "block_bwd1", "block_bwd2",
                       "block_bwd", "bottleneck_bwd")
# What a row's time takes in besides its own pass: the weight-gradient
# products that the wrapper launches (bottleneck_wgrad's row has them
# alone).
INCLUDES = {"bottleneck_bwd1": "dw3 (bottleneck_wgrad)",
            "bottleneck_bwd2": "dw2 (bottleneck_wgrad)",
            "bottleneck_bwd3": "dw1 (bottleneck_wgrad)",
            "bottleneck_bwd": "dW1, dw2, dW3 (bottleneck_wgrad)",
            # The fused block's at C = 128 and 256 only (its rows say so).
            "block_bwd1": "dw2 (bottleneck_wgrad) at C = 128, 256",
            "block_bwd2": "dw1 (bottleneck_wgrad) at C = 128, 256",
            "block_bwd": "dw2, dw1 (bottleneck_wgrad) at C = 128, 256"}


def kernel_args(kind: str, shape, dtype, gen) -> tuple:
    """Seeded inputs of one kernel call on the card: activations, weights
    scaled by 1/sqrt(fan-in), folded BN scales in [0.5, 1.5) and biases of
    both signs."""
    c = shape[-1]

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    def sb(n):
        return (torch.rand(n, generator=gen, device="cuda") + 0.5,
                randn(n, scale=0.5))

    x = randn(*shape).to(dtype)
    if kind == "sbr":
        return (x, *sb(c))
    if kind == "block_fwd":
        std = (1.0 / (9 * c)) ** 0.5
        w1, w2 = randn(3, 3, c, c, scale=std), randn(3, 3, c, c, scale=std)
        return (x, w1, w2, *sb(c), *sb(c))
    f = c // 4
    return (x, randn(c, f, scale=c ** -0.5),
            randn(3, 3, f, f, scale=(9 * f) ** -0.5),
            randn(f, c, scale=f ** -0.5), *sb(c), *sb(f), *sb(f))


def _timed(row, kernel, plain, kind, shape, dtype, reps: int = 10,
           inner: int = 10, bound_of=None) -> dict:
    """Times of kernel and plain version into ``row``, and its bounds
    (``bound_of(flop_per_s)`` where given, else :func:`bound`)."""
    for key, fn in (("ms", kernel), ("plain_ms", plain)):
        row[key] = time_ms(fn, queued=True, reps=reps, inner=inner)
        row["call_" + key] = time_ms(fn, queued=False, reps=reps,
                                     inner=inner)
    bound_of = bound_of or (lambda rate: bound(kind, shape, dtype, rate))
    row["bound_ms"], row["bound_by"] = bound_of(F32_FLOP_PER_S)
    row["bound_us"] = row["bound_ms"] * 1e3
    if kind in TENSOR_CORE_KERNELS:
        row["tc_bound_ms"], row["tc_bound_by"] = bound_of(TF32X3_FLOP_PER_S)
    if kind in INCLUDES and (kind.startswith("bottleneck")
                             or shape[-1] in WIDE_CHANNELS):
        row["includes"] = INCLUDES[kind]
    return row


def kernel_phase(wrappers):
    """Per-shape comparison and timing; returns the per-shape rows. On the
    fused train path ``block_fwd`` runs as the train step runs it, from the
    stats' c1 (``c1=``): kernel and plain version from the plain stats'
    c1."""
    from tpu_resnet_torch.ops import fused_block as fb
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = [(path, kind, shape, n) for path, kinds in SHAPES.items()
             for kind, shapes in kinds.items() for shape, n in shapes]
    for path, kind, shape, per_pass in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args = kernel_args(kind, shape, dtype, gen)
            kernel, plain = wrappers[kind]
            bound_of = None
            if kind == "block_fwd" and path in BLOCK_TRAIN_PATHS:
                x, w1, _, s1, b1, *_ = args
                c1 = fb.block_stats_reference(x, w1, s1, b1)[2]
                kernel = functools.partial(kernel, c1=c1)
                plain = functools.partial(plain, c1=c1)
                bound_of = functools.partial(bound, "block_fwd_c1", shape,
                                             dtype)
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            atol, rtol = TOLERANCE[(kind, dtype)]
            excess = float((d - atol - rtol * want.float().abs()).max())
            row = {"kernel": kind, "path": path, "shape": list(shape),
                   "dtype": str(dtype).split(".")[1],
                   "per_pass": per_pass,
                   "max_abs_err": float(d.max()),
                   "max_rel_err": float(d.max() / want.float().abs().max()),
                   "atol": atol, "rtol": rtol}
            check(got.dtype == dtype and got.shape == want.shape,
                  f"{kind} {shape} {dtype}: wrong output {got.dtype} "
                  f"{tuple(got.shape)}")
            check(excess <= 0, f"{kind} {shape} {dtype}: error beyond "
                  f"tolerance: {row}")
            check(kind != "sbr" or torch.equal(got, want),
                  f"sbr {shape} {dtype}: not bit for bit the plain version")
            if bound_of is not None:
                row["from_c1"] = True
            rows.append(_timed(row, lambda: kernel(*args),
                               lambda: plain(*args), kind, shape, dtype,
                               bound_of=bound_of))
    return rows


def train_kernel_phase(ep, sx):
    """The train paths' backward kernels against their plain versions:
    ``sbr_bwd`` at the CIFAR and ImageNet train paths' sbr shapes, bfloat16
    and float32, and the cross-entropy pair at B=128 for 10, 100 and 1000
    classes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    sbr_cases = [(path, shape, n)
                 for path in ("cifar10_train", "imagenet_fused_train",
                              "imagenet34_fused_train")
                 for shape, n in SHAPES[path]["sbr"]]
    for path, shape, per_step in sbr_cases:
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            sc = torch.rand(c, generator=gen, device="cuda") + 0.5
            bi = torch.randn(c, generator=gen, device="cuda") * 0.5
            got = ep.scale_bias_relu_bwd(x, sc, bi, g)
            want = ep.scale_bias_relu_bwd_reference(x, sc, bi, g)
            torch.cuda.synchronize()
            gm = torch.where(x.float() * sc + bi > 0, g.float(), 0.0)
            rtol, atol = SBR_BWD_TOL
            name = f"sbr_bwd {shape} {dtype}"
            check(got[0].dtype == dtype and torch.equal(got[0], want[0]),
                  f"{name}: dx differs from the plain version")
            again = ep.scale_bias_relu_bwd(x, sc, bi, g)
            check(all(torch.equal(p, q) for p, q in zip(got, again)),
                  f"{name}: two calls differ")
            del again
            excess = 0.0
            for k, terms in ((1, gm * x.float()), (2, gm)):
                limit = rtol * terms.abs().sum(dim=(0, 1, 2)) + atol
                excess = max(excess, float(((got[k] - want[k]).abs()
                                            / limit).max()))
            err = max(float((got[k].float() - want[k].float()).abs().max())
                      for k in range(3))
            row = {"kernel": "sbr_bwd", "path": path,
                   "shape": list(shape), "dtype": str(dtype).split(".")[1],
                   "per_pass": per_step, "max_abs_err": err,
                   "ds_db_err_over_limit": excess,
                   "tolerance": "dx exact; ds, db <= 1e-5*sum|terms| + 1e-6"}
            check(excess <= 1, f"{name}: ds/db beyond tolerance: {row}")
            rows.append(_timed(
                row, lambda: ep.scale_bias_relu_bwd(x, sc, bi, g),
                lambda: ep.scale_bias_relu_bwd_reference(x, sc, bi, g),
                "sbr_bwd", shape, dtype))
    atol, rtol = XENT_TOL
    for path, classes, per_step in XENT_CLASSES:
        shape = (TRAIN_BATCH, classes)
        logits = torch.randn(shape, generator=gen, device="cuda") * 3
        labels = torch.randint(0, classes, (TRAIN_BATCH,), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels64 = labels.long()
        g = torch.rand(TRAIN_BATCH, generator=gen, device="cuda")
        # The mean's cotangent: one value, stride 0.
        g_mean = torch.full((), 1.0 / TRAIN_BATCH, device="cuda").expand(
            TRAIN_BATCH)
        pairs = {
            "xent_fwd": (lambda: sx.softmax_xent_per_example(logits, labels),
                         lambda: sx.softmax_xent_per_example_reference(
                             logits, labels)),
            "xent_bwd": (lambda: sx.softmax_xent_bwd(logits, labels, g),
                         lambda: sx.softmax_xent_bwd_reference(logits,
                                                               labels, g))}
        # The same with int64 labels and, for the backward, the mean's
        # broadcast cotangent: checked, not timed.
        wide = {
            "xent_fwd": (lambda: sx.softmax_xent_per_example(logits,
                                                             labels64),
                         lambda: sx.softmax_xent_per_example_reference(
                             logits, labels64)),
            "xent_bwd": (lambda: sx.softmax_xent_bwd(logits, labels64,
                                                     g_mean),
                         lambda: sx.softmax_xent_bwd_reference(
                             logits, labels64, g_mean))}
        for kind, (kernel, plain) in pairs.items():
            errs = []
            for labels_as, (k, p) in (("int32", (kernel, plain)),
                                      ("int64", wide[kind])):
                got, want = k(), p()
                torch.cuda.synchronize()
                d = (got - want).abs()
                errs.append((d, want))
                check(got.shape == want.shape and bool(
                    (d <= atol + rtol * want.abs()).all()),
                    f"{kind} {shape}, {labels_as} labels: error beyond "
                    f"tolerance: max {float(d.max())}")
            (d, want), (d64, _) = errs
            row = {"kernel": kind, "path": path,
                   "shape": list(shape), "dtype": "float32",
                   "per_pass": per_step, "max_abs_err": float(d.max()),
                   "max_rel_err": float(d.max() / want.abs().max()),
                   "int64_labels_max_abs_err": float(d64.max()),
                   "atol": atol, "rtol": rtol}
            _timed(row, kernel, plain, kind, shape, torch.float32)
            # One PyTorch call computes the forward; none the backward.
            row["library_ms"] = (time_ms(lambda: F.cross_entropy(
                logits, labels64, reduction="none"), queued=True)
                if kind == "xent_fwd" else None)
            rows.append(row)
    return rows


def block_train_args(shape, dtype, gen) -> dict:
    """Seeded inputs of the fused block's training kernels on a coarse
    dyadic grid: x in steps of 1/4, gy of 1/8, weights of 1/32 (|w| <=
    1/8), gammas, betas and means of 1/8, 1/sigma a power of 2. Every
    product and partial sum of the recomputed c1 and of convT(gy, w2) is
    then exact in float32 whatever the order, so the kernel and the plain
    version reach the same c1 and the same masks [z > 0], and the sums and
    dx differ only by rounding."""
    c = shape[-1]

    def grid(size, lo, hi, step):
        return torch.randint(lo, hi + 1, size, generator=gen,
                             device="cuda").float() * step

    def vec(lo, hi, step):
        return grid((c,), lo, hi, step)

    return {"x": grid(shape, -8, 8, 0.25).to(dtype),
            "gy": grid(shape, -16, 16, 0.125),
            "w1": grid((3, 3, c, c), -4, 4, 1 / 32),
            "w2": grid((3, 3, c, c), -4, 4, 1 / 32),
            "g1": vec(4, 12, 1 / 8), "b1": vec(-4, 4, 1 / 8),
            "g2": vec(4, 12, 1 / 8), "b2": vec(-4, 4, 1 / 8),
            "m1": vec(-4, 4, 1 / 8), "i1": 2.0 ** vec(-1, 1, 1),
            "m2": vec(-8, 8, 1 / 8), "i2": 2.0 ** vec(-2, 0, 1)}


def _sum_excess(got, want, scale) -> float:
    """Largest |kernel - plain| over its limit rtol * sum|terms| + atol."""
    rtol, atol = SBR_BWD_TOL
    return max(float(((g - w).abs() / (rtol * s + atol)).max())
               for g, w, s in zip(got, want, scale))


def _fwd_excess(got, want, dtype) -> float:
    """Largest |kernel - plain| over ``block_fwd``'s limit atol + rtol *
    |plain| at ``dtype``."""
    atol, rtol = TOLERANCE[("block_fwd", dtype)]
    d = (got.float() - want.float()).abs()
    return float((d / (atol + rtol * want.float().abs())).max())


def block_train_normal_args(fb, shape, dtype, gen) -> dict:
    """Seeded normal inputs of the fused block's backward passes, as a
    training step gives them: x, gy, weights scaled by 1/sqrt(fan-in),
    gammas in [0.5, 1.5), betas of both signs, and the batch's own BN
    moments (the plain training forward's, as 1/sigma)."""
    c = shape[-1]

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    a = {"x": randn(*shape).to(dtype), "gy": randn(*shape),
         "w1": randn(3, 3, c, c, scale=(9 * c) ** -0.5),
         "w2": randn(3, 3, c, c, scale=(9 * c) ** -0.5),
         "g1": torch.rand(c, generator=gen, device="cuda") + 0.5,
         "b1": randn(c, scale=0.5),
         "g2": torch.rand(c, generator=gen, device="cuda") + 0.5,
         "b2": randn(c, scale=0.5)}
    with torch.backends.cudnn.flags(enabled=False):
        m1, v1, m2, v2 = fb.block_train_fwd_reference(
            a["x"], a["w1"], a["w2"], a["g1"], a["b1"], a["g2"],
            a["b2"])[1]
    return {**a, "m1": m1, "i1": torch.rsqrt(v1 + fb.EPS), "m2": m2,
            "i2": torch.rsqrt(v2 + fb.EPS)}


def z2_mask_flips(fb, a, dz2) -> int:
    """Elements where ``block_bwd1``'s mask [z2 > 0] differs from the plain
    pass's, on the inputs ``a``, read from the kernel's dz2 (``dz2``, dr2
    where its mask is on, 0 where off): the kernel's dz2 lies nearer one of
    the two candidates; counted where dr2 is more than 1e-6 (elsewhere a
    flip moves nothing the tolerance sees)."""
    x, gy, w1, w2 = a["x"], a["gy"], a["w1"], a["w2"]
    vecs = tuple(a[k] for k in ("g1", "b1", "g2", "b2", "m1", "i1", "m2",
                                "i2"))
    with torch.backends.cudnn.flags(enabled=False):
        z2 = fb._recompute(x, w1, *vecs)[3]
        dr2 = fb._conv3x3_t(gy, w2)
    return _flips(dz2, dr2, z2 > 0)


def _flips(handed, on, plain_on) -> int:
    """Elements where a handed-over tensor (``on`` where the kernel's mask
    is on, 0 where off) lies nearer the other candidate than ``plain_on``
    says, counted where ``on`` is more than 1e-6."""
    kernel_on = (handed - on).abs() < handed.abs()
    return int(((kernel_on != plain_on) & (on.abs() > 1e-6)).sum())


def block_train_kernel_phase(fb):
    """The fused block's four training kernels against their plain versions
    at the three CIFAR train shapes, bfloat16 and float32: every sum within
    1e-5 * sum|terms| + 1e-6, pass 1's dz2 and ẑ2 within ``block_fwd``'s
    float32 tolerance, pass 2's dz1 and pass 3's dx within ``block_fwd``'s
    tolerance, two calls bit for bit equal; pass 2 takes the plain pass 1's
    dz2 and ẑ2 and pass 3 the plain pass 2's dz1, so each kernel is checked
    on its own. The oracle's convolutions run with cuDNN off (PyTorch's own
    im2col and cuBLAS GEMM), which keep the exact grid of
    :func:`block_train_args` exact. Each ``block_bwd1`` row carries its mask
    flips (:func:`z2_mask_flips`) on the grid and on normal inputs
    (:func:`block_train_normal_args`)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    cases = [(path, shape, per_step) for path in BLOCK_TRAIN_PATHS
             for shape, per_step in SHAPES[path]["block_fwd"]]
    for path, shape, per_step in cases:
        # Fewer timing repetitions at ImageNet's sizes: a call takes
        # milliseconds.
        timing = ({} if path == "cifar10_fused_train"
                  else {"reps": 5, "inner": 2})
        for dtype in (torch.bfloat16, torch.float32):
            a = block_train_args(shape, dtype, gen)
            x, gy, w1, w2 = a["x"], a["gy"], a["w1"], a["w2"]
            vecs = tuple(a[k] for k in ("g1", "b1", "g2", "b2", "m1", "i1",
                                        "m2", "i2"))
            with torch.backends.cudnn.flags(enabled=False):
                *t, _, dz2, z2hat = fb.train_bwd_pass1_reference(
                    x, gy, w1, w2, *vecs)
                h1 = {"dz2": dz2, "z2hat": z2hat}
                *u, _, dz1 = fb.train_bwd_pass2_reference(x, gy, w1, w2,
                                                          *vecs, *t, **h1)
            calls = {
                "block_stats": ((x, w1, a["g1"], a["b1"]), {},
                                fb.block_stats, fb.block_stats_reference),
                "block_bwd1": ((x, gy, w1, w2, *vecs), {}, fb.block_bwd1,
                               fb.train_bwd_pass1_reference),
                "block_bwd2": ((x, gy, w1, w2, *vecs, *t), h1,
                               fb.block_bwd2, fb.train_bwd_pass2_reference),
                "block_bwd3": ((x, gy, w1, w2, *vecs, *t, *u), {"dz1": dz1},
                               fb.block_bwd3, fb.train_bwd_pass3_reference)}
            for kind, (args, kw, kernel, plain) in calls.items():
                got, again = kernel(*args, **kw), kernel(*args, **kw)
                with torch.backends.cudnn.flags(enabled=False):
                    want = plain(*args, **kw)
                    scale = (plain(*args, **kw, magnitudes=True)
                             if kind != "block_bwd3" else None)
                torch.cuda.synchronize()
                name = f"{kind} {shape} {dtype}"
                if kind == "block_bwd3":
                    got, again, want = (got,), (again,), (want,)
                check(all(torch.equal(p, q) for p, q in zip(got, again)),
                      f"{name}: two calls differ")
                err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
                row = {"kernel": kind, "path": path, "shape": list(shape),
                       "dtype": str(dtype).split(".")[1],
                       "per_pass": per_step, "max_abs_err": err}
                if kind == "block_bwd3":
                    excess = _fwd_excess(got[0], want[0], dtype)
                    check(got[0].dtype == dtype,
                          f"{name}: dx is {got[0].dtype}")
                    atol, rtol = TOLERANCE[("block_fwd", dtype)]
                    row.update(atol=atol, rtol=rtol)
                else:
                    sums = 2 if kind == "block_stats" else 3
                    excess = _sum_excess(got[:sums], want[:sums],
                                         scale[:sums])
                    row["tolerance"] = "sums <= 1e-5*sum|terms| + 1e-6"
                for i, out in {"block_stats": ((2, "c1"),),
                               "block_bwd1": ((3, "dz2"), (4, "z2hat")),
                               "block_bwd2": ((3, "dz1"),)}.get(kind, ()):
                    check(got[i].dtype == torch.float32
                          and got[i].shape == x.shape,
                          f"{name}: {out} is {got[i].dtype} {got[i].shape}")
                    # c1, dz2 and ẑ2 are float32 whatever x's dtype and
                    # exact on the grid; dz1 is held to x's dtype's
                    # tolerance.
                    row[f"{out}_err_over_limit"] = _fwd_excess(
                        got[i], want[i],
                        dtype if kind == "block_bwd2" else torch.float32)
                    excess = max(excess, row[f"{out}_err_over_limit"])
                if kind == "block_stats":
                    # The training forward from this c1 is the forward from
                    # x, bit for bit: one plan, the same c1.
                    fwd = (x, w1, w2, a["g1"], a["b1"], a["g2"], a["b2"])
                    row["fwd_from_c1_equal"] = torch.equal(
                        fb.block_fwd(*fwd, c1=got[2]), fb.block_fwd(*fwd))
                    check(row["fwd_from_c1_equal"], f"{name}: block_fwd "
                          f"from its c1 differs from block_fwd from x")
                if kind == "block_bwd1":
                    normal = block_train_normal_args(fb, shape, dtype, gen)
                    normal_dz2 = fb.block_bwd1(*(normal[k] for k in (
                        "x", "gy", "w1", "w2", "g1", "b1", "g2", "b2", "m1",
                        "i1", "m2", "i2")))[3]
                    row["z2_mask_flips"] = {
                        "grid": z2_mask_flips(fb, a, got[3]),
                        "normal": z2_mask_flips(fb, normal, normal_dz2),
                        "elements": x.numel()}
                row["err_over_limit"] = excess
                check(excess <= 1, f"{name}: beyond tolerance: {row}")
                rows.append(_timed(row, lambda: kernel(*args, **kw),
                                   lambda: plain(*args, **kw), kind, shape,
                                   dtype, **timing))
            del a, x, gy, w1, w2, vecs, t, h1, u, dz1, dz2, z2hat, calls
            torch.cuda.empty_cache()
    return rows


def bottleneck_train_args(shape, dtype, gen) -> tuple:
    """Seeded inputs of the fused bottleneck's training kernels on a coarse
    dyadic grid: x in steps of 1/4 (|x| <= 2), gy of 1/8, weights of 1/32
    (|w| <= 1/8 or 1/16), betas of 1/16, means of 1/4 or 1/8, gammas and
    1/sigma powers of 2. c1, chat, mid and mhat are then exact in float32
    whatever the summation order, so kernel and plain version share their
    masks [m > 0] and the sums and dx differ only by rounding. Returns x,
    gy, w1, w2, w3 and the twelve BN vectors (g, be, mu, 1/sigma of BN1,
    BN2, BN3)."""
    c4 = shape[-1]
    f = c4 // 4

    def grid(size, lo, hi, step):
        return torch.randint(lo, hi + 1, size, generator=gen,
                             device="cuda").float() * step

    def pow2(n, lo, hi):
        return 2.0 ** grid((n,), lo, hi, 1)

    vecs = (pow2(c4, -1, 0), grid((c4,), -4, 4, 1 / 16),
            grid((c4,), -2, 2, 1 / 4), pow2(c4, -1, 0),
            pow2(f, -1, 0), grid((f,), -4, 4, 1 / 16),
            grid((f,), -8, 8, 1 / 8), pow2(f, -3, -2),
            pow2(f, -1, 0), grid((f,), -4, 4, 1 / 16),
            grid((f,), -8, 8, 1 / 8), pow2(f, -1, 0))
    return (grid(shape, -8, 8, 1 / 4).to(dtype), grid(shape, -16, 16, 1 / 8),
            grid((c4, f), -4, 4, 1 / 32), grid((3, 3, f, f), -2, 2, 1 / 32),
            grid((f, c4), -4, 4, 1 / 32), *vecs)


def bottleneck_train_kernel_phase(fbn):
    """The fused bottleneck's six training kernels against their plain
    versions at the three ImageNet B=128 stage shapes, bfloat16 and
    float32, on the dyadic grid of :func:`bottleneck_train_args`: every sum
    and each handed-over tensor (p2, mid, dm3, dmid, dc1) within 1e-5 *
    sum|terms| + 1e-6, pass 1's masks [m2 > 0] (p2 > 0) and [m3 > 0] (from
    mid) equal to the plain pass's, dx within ``bottleneck_fwd``'s
    tolerance, two calls bit for bit equal. ``bottleneck_bwd2`` takes the
    plain pass 1's p2, mid and dm3, ``bottleneck_bwd3`` the plain pass 2's
    dmid and ``bottleneck_bwd4`` the plain pass 3's dc1, so each kernel is
    checked on its own. The oracle's convolutions run with cuDNN off. Fewer timing
    repetitions: each call takes milliseconds."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for shape, per_step in SHAPES["imagenet_fused_train"]["bottleneck_fwd"]:
        for dtype in (torch.bfloat16, torch.float32):
            base = bottleneck_train_args(shape, dtype, gen)
            x, gy, w1, w2, w3, *vecs = base
            with torch.backends.cudnn.flags(enabled=False):
                *t3, _, p2, mid, dm3 = fbn.train_bwd_pass1_reference(*base)
                h1 = {"p2": p2, "mid": mid, "dm3": dm3}
                *t2, _, dmid = fbn.train_bwd_pass2_reference(*base, *t3,
                                                             **h1)
                *t1, _, dc1 = fbn.train_bwd_pass3_reference(
                    *base, *t3, *t2, dmid=dmid)
            calls = {
                "bottleneck_stats_a": ((x, w1, *vecs[:4]), {},
                                       fbn.bottleneck_stats_a,
                                       fbn.bottleneck_stats_a_reference),
                "bottleneck_stats_b": ((x, w1, w2, *vecs[:8]), {},
                                       fbn.bottleneck_stats_b,
                                       fbn.bottleneck_stats_b_reference),
                "bottleneck_bwd1": (base, {}, fbn.bottleneck_bwd1,
                                    fbn.train_bwd_pass1_reference),
                "bottleneck_bwd2": ((*base, *t3), h1, fbn.bottleneck_bwd2,
                                    fbn.train_bwd_pass2_reference),
                "bottleneck_bwd3": ((*base, *t3, *t2), {"dmid": dmid},
                                    fbn.bottleneck_bwd3,
                                    fbn.train_bwd_pass3_reference),
                "bottleneck_bwd4": ((*base, *t3, *t2, *t1), {"dc1": dc1},
                                    fbn.bottleneck_bwd4,
                                    fbn.train_bwd_pass4_reference)}
            for kind, (args, kw, kernel, plain) in calls.items():
                got, again = kernel(*args, **kw), kernel(*args, **kw)
                with torch.backends.cudnn.flags(enabled=False):
                    want = plain(*args, **kw)
                    scale = (plain(*args, **kw, magnitudes=True)
                             if kind != "bottleneck_bwd4" else None)
                torch.cuda.synchronize()
                name = f"{kind} {shape} {dtype}"
                if kind == "bottleneck_bwd4":
                    got, again, want = (got,), (again,), (want,)
                check(all(torch.equal(p, q) for p, q in zip(got, again)),
                      f"{name}: two calls differ")
                err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
                row = {"kernel": kind, "path": "imagenet_fused_train",
                       "shape": list(shape),
                       "dtype": str(dtype).split(".")[1],
                       "per_pass": per_step, "max_abs_err": err}
                if kind == "bottleneck_bwd4":
                    atol, rtol = TOLERANCE[("bottleneck_fwd", dtype)]
                    d = (got[0].float() - want[0].float()).abs()
                    excess = float((d / (atol + rtol * want[0].float().abs()))
                                   .max())
                    check(got[0].dtype == dtype,
                          f"{name}: dx is {got[0].dtype}")
                    row.update(atol=atol, rtol=rtol)
                else:
                    excess = _sum_excess(got, want, scale)
                    row["tolerance"] = "sums <= 1e-5*sum|terms| + 1e-6"
                if kind == "bottleneck_bwd1":
                    g3, be3, mu3, i3 = vecs[8:]
                    check(torch.equal(got[3] > 0, want[3] > 0)
                          and torch.equal(
                              g3 * ((got[4] - mu3) * i3) + be3 > 0,
                              g3 * ((want[4] - mu3) * i3) + be3 > 0),
                          f"{name}: masks [m2 > 0], [m3 > 0] differ from "
                          f"the plain pass's")
                row["err_over_limit"] = excess
                check(excess <= 1, f"{name}: beyond tolerance: {row}")
                rows.append(_timed(row, lambda: kernel(*args, **kw),
                                   lambda: plain(*args, **kw), kind, shape,
                                   dtype, reps=5, inner=2))
            del (base, x, gy, args, kw, calls, h1, p2, mid, dm3, dmid, dc1,
                 got, again, want)
            torch.cuda.empty_cache()
    return rows


def wgrad_bound(p: int, taps: int, ka: int, nb: int, a_item: int,
                bn: bool, flop_per_s: float) -> tuple:
    """(least ms, what bounds it) of one ``weight_grad`` call: A [P,ka]
    (``a_item`` bytes an item) and b [P,nb] float32 read once, the
    [taps,ka,nb] float32 sum written once, BN's four [ka] vectors in;
    2·P·taps·ka·nb flops."""
    moved = p * ka * a_item + p * nb * 4 + taps * ka * nb * 4 + (
        16 * ka if bn else 0)
    t_bytes, t_ops = (moved / HBM_BYTES_PER_S,
                      2 * p * taps * ka * nb / flop_per_s)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bottleneck_wgrad_kernel_phase(wg):
    """``bottleneck_wgrad`` (``wg.weight_grad``, csrc/bottleneck_wgrad.cu)
    alone at the three ResNet-50 B=128 stage shapes, in each of its modes
    as its callers run it: dw3 = Σ p3ᵀ·gy with p3 from mid (BN and ReLU as
    staged), dw2 = Σ p2-patchᵀ·dmid (the 9 shifted taps), dw1 = Σ p1ᵀ·dc1
    from bfloat16 and float32 x (passes 1-3 of the train step), and the
    folded gradient's dW3 from rows of p3 (``bottleneck_bwd``, the A/B
    path); and the fused basic block's at ImageNet ResNet-34's 28²x128 and
    14²x256 B=128 stage shapes in the shifted BN+ReLU mode: dw2 from pass
    1's ẑ2 with (γ2, β2) against gy, dw1 from bfloat16 x with BN1 against
    dc1; within 1e-5·Σ|terms| + 1e-6 of ``weight_grad_reference``, two
    calls bit for bit equal. ``library_ms``: one PyTorch call on the operand
    made beforehand, ``torch.matmul(a.t(), b)`` or, for the 3x3s,
    ``torch.nn.grad.conv2d_weight`` (TF32 off, as ``resolve_device`` sets
    it)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for shape, per_step in SHAPES["imagenet34_fused_train"]["block_fwd"]:
        b, h, w, c = shape
        if c not in WIDE_CHANNELS:
            continue
        p = b * h * w
        z2hat, gy, dc1 = (torch.randn(shape, generator=gen, device="cuda")
                          for _ in range(3))
        x16 = torch.randn(shape, generator=gen,
                          device="cuda").to(torch.bfloat16)
        bn2 = (torch.rand(c, generator=gen, device="cuda") + 0.5,
               torch.randn(c, generator=gen, device="cuda") * 0.5)
        bn1 = (*bn2, torch.randn(c, generator=gen, device="cuda") * 0.5,
               torch.rand(c, generator=gen, device="cuda") + 0.5)
        nchw = (lambda t: t.permute(0, 3, 1, 2))
        r2 = torch.clamp_min(bn2[0] * z2hat + bn2[1], 0.0)
        r1 = torch.clamp_min(bn1[0] * ((x16.float() - bn1[2]) * bn1[3])
                             + bn1[1], 0.0)
        products = (("block dw2", z2hat, gy, bn2, r2),
                    ("block dw1", x16, dc1, bn1, r1))
        for product, a, bmat, vecs, r in products:
            rows.append(_wgrad_row(
                wg, product, wg.SHIFTED_BN_RELU, a, bmat, c, c, 9,
                vecs, "bfloat16", "imagenet34_fused_train", per_step, shape,
                lambda: torch.nn.grad.conv2d_weight(
                    nchw(r), (c, c, 3, 3), nchw(bmat), padding=1)))
        del z2hat, gy, dc1, x16, r1, r2, products
        torch.cuda.empty_cache()
    for shape, per_step in SHAPES["imagenet_fused_train"]["bottleneck_fwd"]:
        b, h, w, c4 = shape
        f, p = c4 // 4, b * h * w

        def randn(*size):
            return torch.randn(size, generator=gen, device="cuda")

        def bn(n):
            return (torch.rand(n, generator=gen, device="cuda") + 0.5,
                    randn(n) * 0.5, randn(n) * 0.5,
                    torch.rand(n, generator=gen, device="cuda") + 0.5)

        def relu_bn(v, vecs):
            g, be, mu, i = vecs
            return torch.clamp_min(g * ((v.float() - mu) * i) + be, 0.0)

        def mm(a, bm):
            return torch.matmul(a.reshape(-1, a.shape[-1]).t(),
                                bm.reshape(-1, bm.shape[-1]))

        gy, mid, dmid, dc1 = randn(b, h, w, c4), *(randn(b, h, w, f)
                                                   for _ in range(3))
        p2 = randn(b, h, w, f).clamp_min(0.0)
        bn3, bn1 = bn(f), bn(c4)
        p3 = relu_bn(mid, bn3)
        x16 = randn(b, h, w, c4).to(torch.bfloat16)
        x32 = x16.float()
        p1 = relu_bn(x32, bn1)
        nchw = (lambda t: t.permute(0, 3, 1, 2))
        # (product, mode, A, b, ka, nb, taps, BN, x dtype, path, per pass,
        # the library call)
        products = (
            ("dw3", wg.BN_RELU, mid, gy, f, c4, 1, bn3, "bfloat16",
             "imagenet_fused_train", per_step, lambda: mm(p3, gy)),
            ("dw2", wg.SHIFTED, p2, dmid, f, f, 9, (), "bfloat16",
             "imagenet_fused_train", per_step,
             lambda: torch.nn.grad.conv2d_weight(
                 nchw(p2), (f, f, 3, 3), nchw(dmid), padding=1)),
            ("dw1", wg.BN_RELU, x16, dc1, c4, f, 1, bn1, "bfloat16",
             "imagenet_fused_train", per_step, lambda: mm(p1, dc1)),
            ("dw1", wg.BN_RELU, x32, dc1, c4, f, 1, bn1, "float32",
             "imagenet_fused_train", per_step, lambda: mm(p1, dc1)),
            ("dW3", wg.ROWS, p3, gy, f, c4, 1, (), "bfloat16",
             "imagenet_ab", 1, lambda: mm(p3, gy)))
        for (product, mode, a, bmat, ka, nb, taps, vecs, dtype, path,
             per_pass, library) in products:
            rows.append(_wgrad_row(wg, product, mode, a, bmat, ka, nb,
                                   taps, vecs, dtype, path, per_pass, shape,
                                   library))
        del gy, mid, dmid, dc1, p2, p3, x16, x32, p1, products
        torch.cuda.empty_cache()
    return rows


def _wgrad_row(wg, product, mode, a, bmat, ka, nb, taps, vecs, dtype, path,
               per_pass, shape, library) -> dict:
    """One ``bottleneck_wgrad`` row: two calls bit for bit equal, within
    1e-5·Σ|terms| + 1e-6 of ``weight_grad_reference``, timed beside it and
    beside ``library``."""
    p = a.numel() // a.shape[-1]

    def kernel():
        return wg.weight_grad("bottleneck_wgrad", mode, a, bmat, ka, nb, a,
                              taps, vecs)

    def plain():
        return wg.weight_grad_reference(mode, a, bmat, vecs)

    got, again = kernel(), kernel()
    with torch.backends.cudnn.flags(enabled=False):
        want = plain()
        scale = wg.weight_grad_reference(mode, a, bmat, vecs,
                                         magnitudes=True)
    torch.cuda.synchronize()
    name = f"bottleneck_wgrad {product} {shape} x {dtype}"
    check(torch.equal(got, again), f"{name}: two calls differ")
    excess = _sum_excess((got,), (want,), (scale,))
    row = {"kernel": "bottleneck_wgrad", "product": product, "mode": mode,
           "path": path, "shape": list(shape), "dtype": dtype,
           "per_pass": per_pass, "operand": [p, taps, ka, nb],
           "max_abs_err": float((got - want).abs().max()),
           "err_over_limit": excess,
           "tolerance": "sums <= 1e-5*sum|terms| + 1e-6"}
    check(excess <= 1, f"{name}: beyond tolerance: {row}")
    del got, again, want, scale
    _timed(row, kernel, plain, "bottleneck_wgrad", shape, dtype, reps=5,
           inner=2, bound_of=lambda rate: wgrad_bound(
               p, taps, ka, nb, a.element_size(), bool(vecs), rate))
    row["library_ms"] = time_ms(library, queued=True, reps=5, inner=2)
    return row


def _bwd_rows(kind, path, shape, dtype, args, kernel, plain, per_pass,
              fwd_kind, **timing) -> dict:
    """One row of a folded block's gradient: two kernel calls bit for bit
    equal, dx within ``fwd_kind``'s tolerance, every sum and weight
    gradient within 1e-5 * sum|terms| + 1e-6 (the oracle's convolutions with
    cuDNN off)."""
    got, again = kernel(*args), kernel(*args)
    with torch.backends.cudnn.flags(enabled=False):
        want = plain(*args)
        scale = plain(*args, magnitudes=True)
    torch.cuda.synchronize()
    name = f"{kind} {shape} {dtype}"
    check(all(torch.equal(p, q) for p, q in zip(got, again)),
          f"{name}: two calls differ")
    check(got[0].dtype == dtype and all(t.dtype == torch.float32
                                        for t in got[1:]),
          f"{name}: output types {[t.dtype for t in got]}")
    atol, rtol = TOLERANCE[(fwd_kind, dtype)]
    d = (got[0].float() - want[0].float()).abs()
    dx_excess = float((d / (atol + rtol * want[0].float().abs())).max())
    excess = _sum_excess(got[1:], want[1:], scale[1:])
    row = {"kernel": kind, "path": path, "shape": list(shape),
           "dtype": str(dtype).split(".")[1], "per_pass": per_pass,
           "max_abs_err": max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want)),
           "dx_err_over_limit": dx_excess, "err_over_limit": excess,
           "atol": atol, "rtol": rtol,
           "tolerance": "dx as the forward; sums and weight gradients "
                        "<= 1e-5*sum|terms| + 1e-6"}
    check(dx_excess <= 1 and excess <= 1, f"{name}: beyond tolerance: {row}")
    del got, again, want, scale
    return _timed(row, lambda: kernel(*args), lambda: plain(*args), kind,
                  shape, dtype, **timing)


def folded_mask_flips(fb, fbn, kind, args) -> int:
    """Elements where the folded gradient's step 1 masks otherwise than the
    plain version ([a2 > 0] of ``block_bwd``, [m3 > 0] of
    ``bottleneck_bwd``), read from the tensor it hands over (dc1 = s2·da2,
    dmid = s3·dm3; 0 where its mask is off), as :func:`z2_mask_flips`
    reads ``block_bwd1``'s dz2; counted where the product is more than
    1e-6."""
    with torch.backends.cudnn.flags(enabled=False):
        if kind == "block_bwd":
            x, gy, w1, w2, s1, b1, scale, b2 = args
            plain_on = fb._c1(x.float(), w1, s1, b1) * scale + b2 > 0
            on = scale * fb._conv3x3_t(gy, w2)
            handed = fb.folded_bwd1(*args)[3]
        else:
            x, gy, w1, w2, w3, s1, b1, s2, b2, scale, b3 = args
            p2 = fbn._folded_chain(x, w1, s1, b1, s2, b2)[-1]
            plain_on = fbn._conv3x3(p2, w2) * scale + b3 > 0
            on = scale * torch.einsum("bhwc,fc->bhwf", gy, w3)
            handed = fbn.folded_bwd1(*args)[5]
    return _flips(handed, on, plain_on)


def fused_bwd_kernel_phase(fb, fbn):
    """The folded blocks' gradients against their plain versions:
    ``block_bwd`` at the three CIFAR stage shapes and ``bottleneck_bwd`` at
    the three ResNet-50 stage shapes, at B=128 (the A/B tools' shapes, one
    call per shape and pass) and at B=GRAD_BATCH (the grad phase's, with
    its launches per backward), and ``block_bwd`` at ImageNet ResNet-34's
    three fused stage shapes at B=128 (``imagenet34_ab``, the A/B tool's
    shapes) and at B=GRAD_BATCH (the eval-mode gradient of its 10 fused
    blocks), bfloat16 and float32, on the dyadic grids
    of :func:`block_train_args` and :func:`bottleneck_train_args` (the
    folded scales and biases taken from their gammas, betas and powers of
    2, so that c1 and mid and with them the masks are exact): each row's
    ``mask_flips`` (:func:`folded_mask_flips`) must be 0."""
    from tpu_resnet_torch.tools import fused_block_ab
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    ab = [(shape, 1) for shape, _ in SHAPES["cifar10_fused_train"]
          ["block_fwd"]]
    ab34 = [(shape, 1) for shape in fused_block_ab.IMAGENET_SHAPES]
    for path, shapes in (("cifar10_ab", ab),
                         ("cifar10_grad", GRAD_SHAPES["cifar10"]),
                         ("imagenet34_ab", ab34),
                         ("imagenet34_grad", GRAD_SHAPES["imagenet34"])):
        timing = {} if path.startswith("cifar10") else {"reps": 5,
                                                        "inner": 2}
        for shape, per_pass in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                a = block_train_args(shape, dtype, gen)
                args = (a["x"], a["gy"], a["w1"], a["w2"], a["g1"], a["b1"],
                        a["g2"], a["b2"])
                rows.append(_bwd_rows(
                    "block_bwd", path, shape, dtype, args, fb.block_bwd,
                    fb.block_bwd_reference, per_pass, "block_fwd", **timing))
                rows[-1]["mask_flips"] = folded_mask_flips(fb, fbn,
                                                           "block_bwd", args)
    ab = [(shape, 1) for shape, _ in SHAPES["imagenet_fused_train"]
          ["bottleneck_fwd"]]
    for path, shapes in (("imagenet_ab", ab),
                         ("imagenet_grad", GRAD_SHAPES["imagenet"])):
        for shape, per_pass in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                x, gy, w1, w2, w3, *v = bottleneck_train_args(shape, dtype,
                                                              gen)
                # s1 = g1, b1 = be1; s2 = i2 (1/8 or 1/4, so that mid stays
                # on the grid), b2 = be2; s3 = g3, b3 = be3.
                args = (x, gy, w1, w2, w3, v[0], v[1], v[7], v[5], v[8],
                        v[9])
                rows.append(_bwd_rows(
                    "bottleneck_bwd", path, shape, dtype, args,
                    fbn.bottleneck_bwd, fbn.bottleneck_bwd_reference,
                    per_pass, "bottleneck_fwd", reps=5, inner=2))
                rows[-1]["mask_flips"] = folded_mask_flips(
                    fb, fbn, "bottleneck_bwd", args)
                del x, gy, args
    torch.cuda.empty_cache()
    for row in rows:
        check(row["mask_flips"] == 0, f"{row['kernel']} {row['shape']} "
              f"{row['dtype']}: masks differ from the plain version's: {row}")
    return rows


# The NaN drill of fault 7: a graphed CIFAR ResNet-8 run whose step-5 batch
# is NaN (resilience.inject_nan_at_step) must roll back from the log
# boundary of step 6 to checkpoint 4, where the reference rolls back.
NAN_DRILL = ["data.dataset=synthetic", "data.synthetic_learnable=true",
             "data.synthetic_train_examples=256", "model.resnet_size=8",
             "model.fused_epilogue=on", "optim.use_pallas_xent=on",
             "data.device_resident=off", "data.transfer_stage=1",
             "train.global_batch_size=16", "train.train_steps=12",
             "train.log_every=2", "train.checkpoint_every=4",
             "train.steps_per_call=4", "resilience.inject_nan_at_step=5"]
NAN_ROLLBACK = [(6, 4)]


def nan_phase(gpu: str) -> dict:
    """Fault 7: every kernel with a ReLU keeps a NaN
    (``tools/nan_check.py``): on inputs with NaNs at seeded places each
    kernel's output is NaN exactly where its plain version's is, bit for
    bit its own output on the clean input wherever the plain version's did
    not move, and within the plain version's rounding elsewhere; then the
    NaN drill (``NAN_DRILL``): the rollback the reference takes,
    ``NAN_ROLLBACK``, and the reference's logged steps."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.obs.spans import load_spans
    from tpu_resnet_torch.tools import nan_check
    from tpu_resnet_torch.train.loop import train

    rows = [nan_check.check(case) for case in nan_check.cases()]
    bad = [row for row in rows if not row["ok"]]
    check(not bad, f"a kernel does not keep the NaN: {bad}")
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_nan_")
    try:
        state = train(load_config("cifar10", "", [
            *NAN_DRILL, f"train.train_dir={train_dir}"]), device="cuda")
        rollbacks = [(s["from_step"], s["to_step"]) for s in load_spans(
            os.path.join(train_dir, "events.jsonl"))
            if s["span"] == "nan_rollback"]
        logged = [r["step"] for r in read_jsonl(
            os.path.join(train_dir, "metrics.jsonl"))]
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    check(state.step == 12 and rollbacks == NAN_ROLLBACK
          and logged == [2, 4, 6, 8, 10, 12],
          f"NaN drill: stopped at {state.step}, rollbacks {rollbacks} "
          f"(the reference's: {NAN_ROLLBACK}), logged steps {logged}")
    result = {"rows": rows, "drill_rollbacks": rollbacks,
              "drill_logged_steps": logged, "gpu": gpu}
    emit("nan", **result)
    return result


def kernel_counters() -> dict:
    """{kernel: (module, launch counter)} of the port's wrappers."""
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    from tpu_resnet_torch.ops import softmax_xent as sx
    from tpu_resnet_torch.ops import wgrad as wg
    return {"sbr": (ep, "launches"), "block_fwd": (fb, "launches"),
            "bottleneck_fwd": (fbn, "launches"),
            "sbr_bwd": (ep, "bwd_launches"), "xent_fwd": (sx, "fwd_launches"),
            "xent_bwd": (sx, "bwd_launches"),
            "block_stats": (fb, "stats_launches"),
            "block_bwd1": (fb, "bwd1_launches"),
            "block_bwd2": (fb, "bwd2_launches"),
            "block_bwd3": (fb, "bwd3_launches"),
            "bottleneck_stats_a": (fbn, "stats_a_launches"),
            "bottleneck_stats_b": (fbn, "stats_b_launches"),
            "bottleneck_bwd1": (fbn, "bwd1_launches"),
            "bottleneck_bwd2": (fbn, "bwd2_launches"),
            "bottleneck_bwd3": (fbn, "bwd3_launches"),
            "bottleneck_bwd4": (fbn, "bwd4_launches"),
            "sbr_add": (ep, "add_launches"),
            "block_bwd": (fb, "bwd_launches"),
            "bottleneck_bwd": (fbn, "bwd_launches"),
            "bottleneck_wgrad": (wg, "launches")}


def zero_counts(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters) -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


@contextlib.contextmanager
def plain_versions():
    """Route the model's and the train step's kernel calls to the plain
    versions (the oracle runs only); the plain sbr and cross-entropy are
    differentiable through their plain backward versions."""
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    from tpu_resnet_torch.ops import softmax_xent as sx
    swaps = ((ep, "scale_bias_relu", ep.scale_bias_relu_reference),
             (fb, "block_fwd", fb.block_fwd_reference),
             (fb, "block_apply", fb.block_apply_reference),
             (fb, "block_train_apply", fb.block_train_apply_reference),
             (fbn, "bottleneck_fwd", fbn.bottleneck_fwd_reference),
             (fbn, "bottleneck_apply", fbn.bottleneck_apply_reference),
             (fbn, "bottleneck_train_apply",
              fbn.bottleneck_train_apply_reference),
             (sx, "softmax_xent_per_example",
              sx.softmax_xent_per_example_reference))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def post(port: int, body: bytes, content_type: str, shape=None) -> tuple:
    """POST /predict?logits=1; returns (response json, seconds)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict?logits=1", data=body,
        headers={"Content-Type": content_type,
                 **({"X-Shape": ",".join(map(str, shape))} if shape else {})})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    return out, time.perf_counter() - t0


def get_status(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


# Each serve path, named by its preset: image size, the requests that check
# the served logits ((count, offset) octet-stream requests; the count of
# images in one JSON request), latency requests at N=1, and the argmax rule.
SERVE_PATHS = {
    "cifar10": {"size": 32, "octet": ((1, 0), (3, 1), (16, 4)), "json": 2,
                "lat1": 40, "argmax": "all"},
    "imagenet": {"size": 224, "octet": ((1, 0), (16, 1)), "json": 1,
                 "lat1": 20, "argmax": "margin"},
    # ImageNet ResNet-34 through its 10 fused blocks at 224².
    "imagenet34": {"size": 224, "octet": ((1, 0), (16, 1)), "json": 1,
                   "lat1": 20, "argmax": "margin", "preset": "imagenet",
                   "overrides": ["model.resnet_size=34"]},
}
N_IMAGES = 256


def serve_phase(path: str, counters, gpu: str, keep: bool = False) -> dict:
    """One serve path (``SERVE_PATHS``); ``keep``: leave its checkpoint's
    train dir for ``serve_arms_phase`` (in ``result["train_dir"]``)."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.models import build_model, init_weights
    from tpu_resnet_torch.serve.infer import make_serve_infer
    from tpu_resnet_torch.serve.server import PredictServer
    from tpu_resnet_torch.train import checkpoint

    spec = SERVE_PATHS[path]
    size = spec["size"]
    train_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{path}_")
    cfg = load_config(spec.get("preset", path), "", [
        "model.fused_blocks=true", "model.fused_epilogue=on",
        f"train.train_dir={train_dir}", "serve.host=127.0.0.1",
        "serve.port=0", *spec.get("overrides", ())])
    check(cfg.data.resolved_image_size == size, f"{path}: image size "
          f"{cfg.data.resolved_image_size}")
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    checkpoint.save(train_dir, 1, model)
    server = PredictServer(cfg, device="cuda")
    try:
        check(server.health()["ok"] is False, "ready before warmup")
        t0 = time.monotonic()
        server.start()
        warm_s = time.monotonic() - t0
        check(tuple(server.buckets) == (1, 2, 4, 8, 16),
              f"buckets {server.buckets}")
        check(get_status(server.port, "/healthz") == 200,
              "/healthz must be 200 once warm")
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (N_IMAGES, size, size, 3),
                              dtype=np.uint8)

        def octet(n, off):
            return post(server.port, images[off:off + n].tobytes(),
                        "application/octet-stream", (n, size, size, 3))

        batches0 = server.batcher.stats()["batches"]
        zero_counts(counters)
        served = []  # (images, logits)
        for n, off in spec["octet"]:
            out, _ = octet(n, off)
            check(out["count"] == n, f"count {out['count']} != {n}")
            served.append((images[off:off + n], np.asarray(out["logits"])))
        js = images[20:20 + spec["json"]]
        out, _ = post(server.port,
                      json.dumps({"instances": js.tolist()}).encode(),
                      "application/json")
        check(out["count"] == len(js), f"json count {out['count']}")
        served.append((js, np.asarray(out["logits"])))
        lat1 = [octet(1, i)[1] for i in range(spec["lat1"])]
        lat16 = [octet(16, i)[1] for i in range(0, N_IMAGES, 16)]
        launches = read_counts(counters)
        forwards = server.batcher.stats()["batches"] - batches0
        check(forwards > 0, "no batch ran")
        want_launches = {k: n * forwards for k, n in PER_PASS[path].items()}
        check(launches == want_launches,
              f"{path}: launch counts {launches} over {forwards} forward "
              f"passes, expected {want_launches}")

        # Oracle: the served model, on the card, through the plain versions.
        infer = make_serve_infer(cfg, server.backend.device)
        served_model = server.backend._model

        def run_all():
            return np.concatenate([
                infer(served_model, images[i:i + 16]).float().cpu().numpy()
                for i in range(0, N_IMAGES, 16)])

        with plain_versions():
            ref = [infer(served_model, im).float().cpu().numpy()
                   for im, _ in served]
            ref_all = run_all()
        kern_all = run_all()
        got = np.concatenate([lg for _, lg in served])
        want = np.concatenate(ref)
        check(got.shape == want.shape and np.isfinite(got).all(),
              f"served logits {got.shape}, finite={np.isfinite(got).all()}")
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        err_all = float(np.abs(kern_all - ref_all).max())
        agree = float(np.mean(kern_all.argmax(-1) == ref_all.argmax(-1)))
        check(err <= LOGIT_TOL * scale,
              f"served logits differ by {err} (scale {scale})")
        check(err_all <= LOGIT_TOL * scale,
              f"batched logits differ by {err_all} (scale {scale})")
        top2 = np.sort(ref_all, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * err_all
        if spec["argmax"] == "all":
            check(bool((got.argmax(-1) == want.argmax(-1)).all()),
                  "served argmax differs from the plain-version model")
            check(agree >= ARGMAX_AGREE,
                  f"argmax agreement {agree} over {N_IMAGES}")
        else:
            check(bool(clear.any()), "no image's top-1/top-2 margin exceeds "
                  f"twice the max logit difference {err_all}")
            check(bool((kern_all.argmax(-1) == ref_all.argmax(-1))[clear]
                       .all()), "argmax differs from the plain-version "
                  "model on an image with a clear margin")
    finally:
        clean = server.drain(timeout=60)
        server.close()
        if not keep:
            shutil.rmtree(train_dir, ignore_errors=True)
    check(clean, "server did not drain cleanly")
    result = {
        "path": path,
        "model": f"{cfg.data.dataset} ResNet-{cfg.model.resnet_size} "
                 f"{size}x{size} fused_blocks=on fused_epilogue=on bf16",
        "params": sum(p.numel() for p in model.parameters()),
        "warmup_s": warm_s, "forwards": forwards, "launches": launches,
        "per_forward": {k: v / forwards for k, v in launches.items()},
        "logits_max_abs_err": err, "batched_max_abs_err": err_all,
        "logits_scale": scale, "logit_tol_fraction": LOGIT_TOL,
        f"argmax_agreement_{N_IMAGES}": agree,
        "clear_margin_images": int(clear.sum()),
        "p50_request_ms_n1": statistics.median(lat1) * 1e3,
        "p50_request_ms_n16": statistics.median(lat16) * 1e3,
        "images_per_s_n16": 16 * len(lat16) / sum(lat16),
        "gpu": gpu, "drained_clean": clean,
    }
    emit("serve", **result)
    if keep:
        result["train_dir"] = train_dir
    return result


# The serve arms' request mix: the serve phase's check requests, and fewer
# latency requests (the phase's budget).
ARMS_LAT1 = 10
ARMS_LAT16 = 8
ARMS_WEIGHT_RATIO = 0.30   # int8 weight bytes over the float32 arm's
ADMIT_BYTES = 1 << 30


def _arm_requests(server, path: str, images) -> dict:
    """``serve_phase``'s check requests, then the latency requests at N=1
    and N=16; returns the served (images, logits), the latencies, and the
    requests and images sent."""
    size = images.shape[1]
    spec = SERVE_PATHS[path]
    served, sent = [], {"requests": 0, "images": 0}

    def octet(n, off):
        sent["requests"] += 1
        sent["images"] += n
        return post(server.port, images[off:off + n].tobytes(),
                    "application/octet-stream", (n, size, size, 3))

    for n, off in spec["octet"]:
        out, _ = octet(n, off)
        check(out["count"] == n, f"count {out['count']} != {n}")
        served.append((images[off:off + n], np.asarray(out["logits"])))
    js = images[20:20 + spec["json"]]
    out, _ = post(server.port, json.dumps({"instances": js.tolist()}).encode(),
                  "application/json")
    sent["requests"] += 1
    sent["images"] += len(js)
    served.append((js, np.asarray(out["logits"])))
    lat1 = [octet(1, i)[1] for i in range(ARMS_LAT1)]
    lat16 = [octet(16, 16 * i)[1] for i in range(ARMS_LAT16)]
    return {"served": served, "lat1": lat1, "lat16": lat16, **sent}


def _against_plain(served, infer, model, tol_name: str) -> dict:
    """The served logits against ``model`` run through the plain versions
    on the same images: within ``LOGIT_TOL`` of the largest plain logit."""
    with plain_versions():
        want = np.concatenate([infer(model, im).float().cpu().numpy()
                               for im, _ in served])
    got = np.concatenate([lg for _, lg in served])
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{tol_name}: logits {got.shape}, finite={np.isfinite(got).all()}")
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    check(err <= LOGIT_TOL * scale, f"{tol_name}: logits differ from the "
          f"plain versions' by {err} (scale {scale})")
    return {"logits_max_abs_err": err, "logits_scale": scale}


def _scrape_check(server, sent: dict, batches: int) -> dict:
    """``/metrics`` after the arm: requests, images and batches as sent
    and batched, and each histogram's count as its samples."""
    from tpu_resnet_torch import obs

    text = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/metrics", timeout=30).read().decode()
    gauges = obs.parse_prometheus(text)
    hists = obs.parse_histograms(text)
    ns = "tpu_resnet_"
    got = {"requests": gauges[ns + "serve_requests_total"],
           "images": gauges[ns + "serve_images_total"],
           "batches": gauges[ns + "serve_batches_total"],
           "latency_count": hists[ns + "serve_latency_ms"]["count"],
           "queue_wait_count": hists[ns + "serve_queue_wait_ms"]["count"],
           "pad_fraction_count": hists[ns + "serve_pad_fraction"]["count"],
           "time_to_ready_count": hists[ns + "serve_time_to_ready_s"]["count"]}
    want = {"requests": sent["requests"], "images": sent["images"],
            "batches": batches, "latency_count": sent["requests"],
            "queue_wait_count": sent["requests"],
            "pad_fraction_count": batches, "time_to_ready_count": 1}
    check(got == want, f"/metrics {got}, sent and batched {want}")
    names = {line.split()[2] for line in text.splitlines()
             if line.startswith("# TYPE")}
    check(all(ns + name in names for name, _ in obs.SERVE_GAUGES)
          and all(ns + name in names for name, _, _ in obs.SERVE_HISTOGRAMS),
          "a serve series is missing from /metrics")
    return got


def serve_arms_phase(counters, gpu: str, served: list) -> list:
    """The frozen and the int8 serve arms on the serve phase's checkpoints
    (their train dirs are removed here): (a) the ImageNet ResNet-50
    checkpoint exported with a dynamic batch and served with
    ``serve.backend=export``; (c) its ``/metrics`` and
    ``colocation_admission`` on the card; (b) CIFAR-10 ResNet-50 fused with
    ``serve.quantize=int8``, calibrated on the synthetic eval split, served,
    then exported quantized. Returns the two arms' results, which join the
    ``kernels`` line."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.export import export_from_checkpoint, load_inference
    from tpu_resnet_torch.models import build_model
    from tpu_resnet_torch.resilience import elastic
    from tpu_resnet_torch.serve.backend import CheckpointBackend
    from tpu_resnet_torch.serve.infer import make_serve_infer
    from tpu_resnet_torch.serve.server import PredictServer
    from tpu_resnet_torch.train import checkpoint

    cuda = torch.device("cuda")
    dirs = {s["path"]: s["train_dir"] for s in served if "train_dir" in s}
    results = []
    try:
        # (a) the export arm, ImageNet ResNet-50 at 224².
        path, size = "imagenet", SERVE_PATHS["imagenet"]["size"]
        export_dir = os.path.join(dirs[path], "export")
        base = ["model.fused_blocks=true", "model.fused_epilogue=on",
                f"train.train_dir={dirs[path]}", "serve.host=127.0.0.1",
                "serve.port=0"]
        cfg = load_config(path, "", base + ["serve.backend=export",
                                            f"serve.export_dir={export_dir}"])
        t0 = time.monotonic()
        export_from_checkpoint(cfg, export_dir, device="cuda")
        export_s = time.monotonic() - t0
        artifact_mb = os.path.getsize(
            os.path.join(export_dir, "inference.pt2")) / 2**20
        server = PredictServer(cfg, device="cuda")
        try:
            t0 = time.monotonic()
            server.start()
            warm_s = time.monotonic() - t0
            images = np.random.default_rng(0).integers(
                0, 256, (N_IMAGES, size, size, 3), dtype=np.uint8)
            batches0 = server.batcher.stats()["batches"]
            zero_counts(counters)
            sent = _arm_requests(server, path, images)
            launches = read_counts(counters)
            batches = server.batcher.stats()["batches"]
            forwards = batches - batches0
            want = {k: n * forwards for k, n in PER_PASS[path].items()}
            check(forwards > 0 and launches == want,
                  f"export arm: launches {launches} over {forwards} "
                  f"forwards, expected {want}")
            # Oracle: the live checkpoint model through the plain versions.
            live = checkpoint.load_state(
                build_model(cfg), checkpoint.restore(dirs[path], 1))
            errs = _against_plain(sent["served"],
                                  make_serve_infer(cfg, cuda),
                                  live.to(cuda).eval(), "export arm")
            scraped = _scrape_check(server, sent, batches)
        finally:
            clean = server.drain(timeout=60)
            server.close()
        check(clean, "export arm: server did not drain cleanly")
        free, total = torch.cuda.mem_get_info()
        admit = elastic.colocation_admission(ADMIT_BYTES, device=cuda)
        deny = elastic.colocation_admission(2 * total, device=cuda)
        check(admit["admit"] and not deny["admit"]
              and admit["limit_bytes"] == total,
              f"colocation admission: {admit} / {deny}")
        result = {
            "path": "imagenet_export", "arm": "serve.backend=export",
            "export_s": export_s, "artifact_mb": artifact_mb,
            "warmup_s": warm_s, "forwards": forwards, "launches": launches,
            "per_forward": {k: v / forwards for k, v in launches.items()},
            **errs, "logit_tol_fraction": LOGIT_TOL,
            "p50_request_ms_n1": statistics.median(sent["lat1"]) * 1e3,
            "p50_request_ms_n16": statistics.median(sent["lat16"]) * 1e3,
            "images_per_s_n16": 16 * len(sent["lat16"]) / sum(sent["lat16"]),
            "metrics": scraped,
            "admission_1gib": admit, "admission_2x_card": deny,
            "gpu": gpu, "drained_clean": clean}
        emit("serve_arms", **result)
        results.append(result)

        # (b) the int8 arm, CIFAR-10 ResNet-50 fused, on synthetic data.
        path, size = "cifar10", SERVE_PATHS["cifar10"]["size"]
        base = ["model.fused_blocks=true", "model.fused_epilogue=on",
                f"train.train_dir={dirs[path]}", "serve.host=127.0.0.1",
                "serve.port=0", "data.dataset=synthetic"]
        qcfg = load_config(path, "", base + ["serve.quantize=int8"])
        fcfg = load_config(path, "", base)
        images = np.random.default_rng(1).integers(
            0, 256, (N_IMAGES, size, size, 3), dtype=np.uint8)
        t0 = time.monotonic()
        server = PredictServer(qcfg, device="cuda")
        try:
            server.start()
            warm_s = time.monotonic() - t0
            batches0 = server.batcher.stats()["batches"]
            zero_counts(counters)
            sent = _arm_requests(server, path, images)
            launches = read_counts(counters)
            forwards = server.batcher.stats()["batches"] - batches0
            want = {k: n * forwards for k, n in PER_PASS[path].items()}
            check(forwards > 0 and launches == want,
                  f"int8 arm: launches {launches} over {forwards} "
                  f"forwards, expected {want}")
            qmodel = server.backend._model
            infer = make_serve_infer(qcfg, cuda)
            errs = _against_plain(sent["served"], infer, qmodel, "int8 arm")
            q_bytes = server.backend.weight_argument_bytes()
            digest = server.backend.calibration_digest
        finally:
            clean = server.drain(timeout=60)
            server.close()
        check(clean, "int8 arm: server did not drain cleanly")
        f32 = CheckpointBackend(fcfg, cuda)
        f_bytes = f32.weight_argument_bytes()
        check(q_bytes <= ARMS_WEIGHT_RATIO * f_bytes,
              f"int8 weight bytes {q_bytes} > {ARMS_WEIGHT_RATIO} x "
              f"{f_bytes}")
        agree = float(np.mean(np.concatenate([
            infer(qmodel, images[i:i + 16]).float().cpu().numpy()
            .argmax(-1) == f32.infer(images[i:i + 16]).argmax(-1)
            for i in range(0, N_IMAGES, 16)])))
        f32.close()
        # The quantized export of the same checkpoint and calibration.
        q_dir = os.path.join(dirs[path], "export_int8")
        t0 = time.monotonic()
        export_from_checkpoint(qcfg, q_dir, device="cuda")
        q_export_s = time.monotonic() - t0
        bundle = load_inference(q_dir, cuda)
        check(bundle.manifest["calibration_digest"] == digest
              and bundle.manifest["weight_bytes"] == q_bytes,
              f"int8 manifest {bundle.manifest}, digest {digest}, "
              f"bytes {q_bytes}")
        zero_counts(counters)
        got = np.concatenate([bundle(images[i:i + 16])
                              for i in range(0, 64, 16)])
        exported_launches = read_counts(counters)
        check(exported_launches == {k: 4 * n for k, n in
                                    PER_PASS[path].items()},
              f"int8 export: launches {exported_launches} over 4 forwards")
        live = np.concatenate([infer(qmodel, images[i:i + 16]).float().cpu()
                               .numpy() for i in range(0, 64, 16)])
        export_err = float(np.abs(got - live).max())
        check(export_err <= LOGIT_TOL * float(np.abs(live).max()),
              f"int8 export serves logits {export_err} from the live arm's")
        result = {
            "path": "cifar10_int8", "arm": "serve.quantize=int8",
            "warmup_s": warm_s, "forwards": forwards, "launches": launches,
            "per_forward": {k: v / forwards for k, v in launches.items()},
            **errs, "logit_tol_fraction": LOGIT_TOL,
            "weight_bytes_int8": q_bytes, "weight_bytes_f32": f_bytes,
            "weight_ratio": q_bytes / f_bytes,
            "calibration_digest": digest,
            f"argmax_agreement_f32_{N_IMAGES}": agree,
            "export_int8_s": q_export_s,
            "export_int8_artifact_mb": os.path.getsize(
                os.path.join(q_dir, "inference.pt2")) / 2**20,
            "export_int8_max_abs_err": export_err,
            "p50_request_ms_n1": statistics.median(sent["lat1"]) * 1e3,
            "p50_request_ms_n16": statistics.median(sent["lat16"]) * 1e3,
            "images_per_s_n16": 16 * len(sent["lat16"]) / sum(sent["lat16"]),
            "gpu": gpu, "drained_clean": clean}
        emit("serve_arms", **result)
        results.append(result)
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    return results


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def imagenet_batches(n: int, batch: int, classes: int, size: int) -> list:
    """``n`` seeded (uint8 [batch,size,size,3], int32 labels in
    0..classes-1) batches: what the ImageNet input pipeline hands the
    device."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
             rng.integers(0, classes, batch).astype(np.int32))
            for _ in range(n)]


def step_batch(cfg, batch: int) -> tuple:
    """One seeded augmented batch (x, labels) on the card for the float32
    step gate: CIFAR synthetic data, or seeded uint8 ImageNet images."""
    from tpu_resnet_torch.data import augment as aug
    from tpu_resnet_torch.data.cifar import synthetic_data

    cuda = torch.device("cuda")
    size, classes = cfg.data.resolved_image_size, cfg.data.num_classes
    if cfg.data.dataset == "imagenet":
        images, labels = imagenet_batches(1, batch, classes, size)[0]
    else:
        images, labels = synthetic_data(batch, size, classes, learnable=True)
    x = aug.get_train_augment(cfg.data.dataset)(
        torch.from_numpy(images).to(cuda), aug.step_key(0, 0))
    return x, torch.from_numpy(labels).to(cuda)


def rank_step(cfg, state, mesh=None):
    """The train step on preprocessed floats: one card's, or with ``mesh``
    (a ``parallel.Mesh`` of an open process group) a rank's, with the
    update of ``cfg.mesh.partition`` (zero1 takes over ``state``'s
    momentum)."""
    from tpu_resnet_torch.parallel import zero
    from tpu_resnet_torch.train import schedule as sched_lib
    from tpu_resnet_torch.train.loop import per_replica_bn
    from tpu_resnet_torch.train.step import make_train_step

    update = zero.attach(state, cfg.mesh, mesh)
    return make_train_step(cfg.optim, sched_lib.build_schedule(
        cfg.optim, cfg.train), cfg.data.num_classes, mesh=mesh,
        per_replica_bn=per_replica_bn(cfg, mesh), update=update)


def step_arms(cfg, counters, arms, x, y, mesh=None) -> dict:
    """One float32 train step per arm from one seeded state and batch (x,
    y): ``arms`` maps a name to a context factory the step runs under;
    with ``mesh`` each is a rank's step (:func:`rank_step`). Returns
    {name: (state, metrics, launch counts)}."""
    from tpu_resnet_torch.train.loop import build_state

    cuda = torch.device("cuda")
    runs = {}
    for arm, context in arms.items():
        state = build_state(cfg, cuda)
        step_fn = rank_step(cfg, state, mesh)
        zero_counts(counters)
        with context():
            m = step_fn(state, x, y)
        torch.cuda.synchronize()
        runs[arm] = (state, {k: float(v) for k, v in m.items()},
                     read_counts(counters))
        del state
    return runs


def step_diff(got, want) -> dict:
    """Two steps' (state, metrics) compared: the metrics' relative errors,
    and every updated tensor's and momentum buffer's largest |d| over its
    limit atol + rtol * |want| (``STATE_TOL``)."""
    (gs, gm), (ws, wm) = got[:2], want[:2]
    out = {f"{k}_rel_err": _rel(gm[k], wm[k])
           for k in ("loss", "precision", "grad_norm")}
    atol, rtol = STATE_TOL
    pairs = [(f"state {n}", t, ws.model.state_dict()[n])
             for n, t in gs.model.state_dict().items()]
    gb, wb = gs.momentum_buffers(), ws.momentum_buffers()
    check(set(gb) == set(wb) and len(gb) > 0, "momentum buffers differ")
    pairs += [(f"momentum {n}", gb[n], wb[n]) for n in gb]
    excess = sorted(((float(((g - w).abs() / (atol + rtol * w.abs())).max()),
                      name) for name, g, w in pairs), reverse=True)
    out.update(tensors_compared=len(pairs),
               worst_err_over_limit=excess[0][0],
               tensors_over_limit=sum(e > 1 for e, _ in excess),
               worst_tensors=[[name, e] for e, name in excess[:5]])
    return out


@contextlib.contextmanager
def plain_native_convs():
    """The plain versions with cuDNN off: PyTorch's own convolutions, which
    sum in another order than cuDNN's (the control of ``compare_step``)."""
    with plain_versions(), torch.backends.cudnn.flags(enabled=False):
        yield


def compare_step(cfg, counters, path: str, batch: int = TRAIN_BATCH,
                 mesh=None) -> dict:
    """One float32 train step from one seeded state through the kernels,
    and one through the plain versions; every metric and updated tensor
    compared against the step limits (``STEP_RTOL``, ``STATE_TOL``), and the
    kernel step's launches against ``path``'s table. With ``mesh`` the
    steps are this rank's, on its rows of the ``batch``.

    Where the kernels replace convolutions (the fused blocks), the two
    steps sum their convolutions in different orders, and no two
    implementations of the step meet those limits: a backward mask [z > 0]
    recomputed from a conv output flips wherever z lies within rounding of
    0, and the step carries each flip down to the first layers' gradients.
    So the step is also run as the control, the plain versions on PyTorch's
    own convolutions, and the comparison passes when the step limits hold or
    when the kernels' step lies within ``CONTROL_FACTOR`` times the
    control's distance from the plain step (the worst tensor over the
    limit); loss and precision are held to ``STEP_RTOL`` either way, and
    grad_norm's error is reported beside the control's (a scalar of the
    whole gradient, it moves with a few flipped masks: 1.4-8x the
    control's over four weight seeds on an H100)."""
    arms = {"kernels": contextlib.nullcontext, "plain": plain_versions}
    fused = (PER_PASS[path]["block_fwd"] + PER_PASS[path]["bottleneck_fwd"]
             > 0)
    if fused:
        arms["control"] = plain_native_convs
    x, y = step_batch(cfg, batch)
    if mesh is not None:
        lo, hi = mesh.rank_rows(batch)
        x, y, batch = x[lo:hi], y[lo:hi], hi - lo
    runs = step_arms(cfg, counters, arms, x, y, mesh)
    (_, km, kc), (_, pm, pc) = runs["kernels"], runs["plain"]
    check(kc == PER_PASS[path], f"kernel step launches {kc}")
    check(not any(pc.values()), f"plain step launched kernels: {pc}")
    out = {"batch": batch, "metrics_kernels": km, "metrics_plain": pm,
           **step_diff(runs["kernels"], runs["plain"])}
    out["step_limits_held"] = (
        all(out[f"{k}_rel_err"] <= STEP_RTOL
            for k in ("loss", "precision", "grad_norm"))
        and out["worst_err_over_limit"] <= 1)
    ok = out["step_limits_held"]
    if fused:
        control = step_diff(runs["control"], runs["plain"])
        out["control_vs_plain"] = control
        out["control_factor"] = CONTROL_FACTOR
        ok = ok or (
            all(out[f"{k}_rel_err"] <= STEP_RTOL
                for k in ("loss", "precision"))
            and out["worst_err_over_limit"]
            <= CONTROL_FACTOR * max(control["worst_err_over_limit"], 1.0))
    check(ok, f"f32 step beyond {STEP_RTOL} (metrics) or {STATE_TOL} (atol, "
          f"rtol; tensors), and beyond {CONTROL_FACTOR} x the control: {out}")
    return out


def train_phase(path: str, counters, gpu: str) -> dict:
    """The port's training entry point at full width on one train path
    (``TRAIN_PATHS``): the f32 kernel-vs-plain step, 100 bf16 steps through
    ``train()``, the resume to 120, eval once, and the step's device
    profile."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.data.cifar import synthetic_data
    from tpu_resnet_torch.evaluation.evaluator import evaluate
    from tpu_resnet_torch.tools.profiling import (host_batches,
                                                  profile_train_step)
    from tpu_resnet_torch.train import checkpoint
    from tpu_resnet_torch.train.loop import make_loop_step, train

    spec = TRAIN_PATHS[path]
    overrides = [*TRAIN_OVERRIDES, *spec["overrides"]]
    compared = compare_step(load_config("cifar10", "", [
        *overrides, "model.compute_dtype=float32"]), counters, path)
    train_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{path}_")
    try:
        cfg = load_config("cifar10", "", [
            *overrides, f"train.train_dir={train_dir}",
            f"train.train_steps={TRAIN_STEPS}", "train.log_every=1",
            "train.checkpoint_every=50"])
        runs = {}
        for total in (TRAIN_STEPS, RESUME_STEPS):
            cfg.train.train_steps = total
            zero_counts(counters)
            t0 = time.monotonic()
            state = train(cfg, device="cuda")
            torch.cuda.synchronize()
            runs[total] = (time.monotonic() - t0, read_counts(counters))
            check(state.step == total, f"train() stopped at {state.step}")
        with open(os.path.join(train_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        steps = [r["step"] for r in recs]
        check(steps == list(range(1, RESUME_STEPS + 1)),
              f"metrics.jsonl steps {steps[:3]}..{steps[-3:]}")
        losses = [r["loss"] for r in recs]
        check(all(np.isfinite(losses)), "a logged loss is not finite")
        first10 = float(np.mean(losses[:10]))
        last10 = float(np.mean(losses[TRAIN_STEPS - 10:TRAIN_STEPS]))
        check(last10 < first10, f"loss did not fall: first 10 mean "
              f"{first10}, last 10 of {TRAIN_STEPS} {last10}")
        per_step = PER_PASS[path]
        for total, start in ((TRAIN_STEPS, 0), (RESUME_STEPS, TRAIN_STEPS)):
            want = {k: n * (total - start) for k, n in per_step.items()}
            check(runs[total][1] == want, f"train to {total}: launch counts "
                  f"{runs[total][1]}, expected {want}")
        saved = checkpoint.all_steps_in(train_dir)
        check(saved[-2:] == [TRAIN_STEPS, RESUME_STEPS],
              f"checkpoints {saved}")

        cfg.train.eval_once = True
        zero_counts(counters)
        precision = evaluate(cfg, device="cuda")
        eval_counts = read_counts(counters)
        with open(os.path.join(train_dir, "eval", "metrics.jsonl")) as f:
            eval_rec = json.loads(f.readlines()[-1])
        forwards = -(-cfg.data.eval_examples // cfg.train.eval_batch_size)
        want = {k: spec["eval_per_forward"].get(k, 0) * forwards
                for k in KERNELS}
        check(eval_counts == want, f"eval launch counts {eval_counts}, "
              f"expected {want}")
        check(eval_rec["step"] == RESUME_STEPS and precision is not None
              and np.isfinite(eval_rec["eval_loss"]), f"eval {eval_rec}")

        images, labels = synthetic_data(TRAIN_BATCH, 32,
                                        cfg.data.num_classes, learnable=True)
        cuda = torch.device("cuda")
        prof = profile_train_step(state, make_loop_step(cfg, cuda),
                                  host_batches(images, labels, cuda),
                                  iters=TRAIN_PROFILE_STEPS)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    # The loop's speed over the window of steps 2..TRAIN_STEPS (step 1 pays
    # the builds), from the wall stamps of metrics.jsonl: stalls included.
    window_s = recs[TRAIN_STEPS - 1]["wall"] - recs[0]["wall"]
    rates = [r["steps_per_sec"] for r in recs[1:TRAIN_STEPS]
             if "steps_per_sec" in r]
    result = {
        "path": path,
        "model": f"cifar10 ResNet-50 32x32 {spec['label']} "
                 "fused_epilogue=on use_pallas_xent=on bf16, B=128",
        "f32_step_vs_plain": compared,
        "steps": RESUME_STEPS, "resumed_from": TRAIN_STEPS,
        "train_seconds": runs[TRAIN_STEPS][0],
        "resume_seconds": runs[RESUME_STEPS][0],
        "launches": {k: runs[TRAIN_STEPS][1][k] + runs[RESUME_STEPS][1][k]
                     for k in KERNELS},
        "launches_per_step": per_step,
        "loss_first10_mean": first10, "loss_last10_mean": last10,
        "loss_at": {str(s): losses[s - 1] for s in (1, 50, 100, 120)},
        "precision_last10_mean": float(np.mean(
            [r["precision"] for r in recs[TRAIN_STEPS - 10:TRAIN_STEPS]])),
        "loop_window_steps": TRAIN_STEPS - 1, "loop_window_s": window_s,
        "loop_ms_per_step": 1e3 * window_s / (TRAIN_STEPS - 1),
        "loop_images_per_s": TRAIN_BATCH * (TRAIN_STEPS - 1) / window_s,
        "step_ms_median": 1e3 / statistics.median(rates),
        "eval_precision": precision, "eval_loss": eval_rec["eval_loss"],
        "eval_forwards": forwards, "eval_launches": eval_counts,
        "profile": {k: v for k, v in prof.items() if k != "kernels"},
        "profile_top_kernels": prof["kernels"][:12],
        "gpu": gpu}
    emit("train", **result)
    return result


def imagenet_train_phase(counters, gpu: str,
                         path: str = "imagenet_fused_train") -> dict:
    """ImageNet training at 224x224, full depth and width, B=128, bf16, on
    one of ``IMAGENET_TRAIN_PATHS`` (``IMAGENET_OVERRIDES``): ResNet-50
    through its 10 fused bottlenecks, or ResNet-34 through its 10 fused
    basic blocks. The float32 kernel-vs-plain step gate
    (B=IMAGENET_GATE_BATCH), then the loop's own step (``build_state`` +
    ``make_loop_step``, as ``train()`` builds them) for IMAGENET_STEPS
    steps on IMAGENET_BATCHES seeded uint8 batches repeated, dispatched as
    the loop does at the preset's ``train.steps_per_call`` (chunks of CUDA
    graph replays, ``ChunkRunner``), the counters zeroed just before and
    read just after; every step's loss finite and the mean of the last 5
    below the first 5's; then the step's device profile (ResNet-34: over
    IMAGENET34_PROFILE_STEPS steps, with the step's peak device memory, and
    the unfused ResNet-34 step's profile and peak beside it)."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.data.device_data import WARMUP_STEPS, ChunkRunner
    from tpu_resnet_torch.tools.profiling import (device_batches,
                                                  profile_train_step)
    from tpu_resnet_torch.train.loop import build_state, make_loop_step

    spec = IMAGENET_TRAIN_PATHS[path]
    overrides = [*IMAGENET_OVERRIDES, *spec["overrides"]]
    compared = compare_step(load_config("imagenet", "", [
        *overrides, "model.compute_dtype=float32"]), counters, path,
        IMAGENET_GATE_BATCH)
    cfg = load_config("imagenet", "", overrides)
    size, classes = cfg.data.resolved_image_size, cfg.data.num_classes
    check(size == 224 and classes == 1000
          and cfg.model.resnet_size == spec["resnet_size"],
          f"imagenet preset: {size}x{size}, {classes} classes, "
          f"ResNet-{cfg.model.resnet_size}")
    per_call = cfg.train.steps_per_call
    check(per_call > 1, f"imagenet preset: steps_per_call {per_call}")
    cuda = torch.device("cuda")
    state = build_state(cfg, cuda)
    step_fn = make_loop_step(cfg, cuda)
    host = imagenet_batches(IMAGENET_BATCHES, TRAIN_BATCH, classes, size)
    batches = [(torch.from_numpy(im).to(cuda), torch.from_numpy(lb).to(cuda))
               for im, lb in host]
    runner = ChunkRunner(step_fn, cuda, per_call, record_steps=True)
    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.monotonic()
    for start in range(0, IMAGENET_STEPS, per_call):
        runner.run_batches(state, [
            batches[i % IMAGENET_BATCHES]
            for i in range(start, min(start + per_call, IMAGENET_STEPS))])
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = read_counts(counters)
    losses = [float(m["loss"]) for m in runner.recorded]
    capture_seconds = runner.capture_seconds
    check(runner.replays == IMAGENET_STEPS - WARMUP_STEPS,
          f"{runner.replays} replays for {IMAGENET_STEPS} steps")
    runner.close()
    want = {k: n * IMAGENET_STEPS for k, n in PER_PASS[path].items()}
    check(counts == want, f"{path}: launch counts {counts} over "
          f"{IMAGENET_STEPS} steps, expected {want}")
    check(state.step == IMAGENET_STEPS, f"state at step {state.step}")
    check(len(losses) == IMAGENET_STEPS and all(np.isfinite(losses)),
          f"a loss is not finite: {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last5 < first5, f"loss did not fall: first 5 mean {first5}, "
          f"last 5 {last5}")
    params = sum(p.numel() for p in state.model.parameters())
    if path == "imagenet_fused_train":
        prof = profile_train_step(state, step_fn,
                                  device_batches(*host[0], cuda),
                                  iters=INPUT_PROFILE_STEPS)
        unfused = {}
    else:
        prof = _peak_profile(state, step_fn, host[0], cuda)
        del state, step_fn, runner, batches
        gc_collect()
        ucfg = load_config("imagenet", "", [*overrides,
                                            "model.fused_blocks=false"])
        ustate = build_state(ucfg, cuda)
        unfused = _peak_profile(ustate, make_loop_step(ucfg, cuda), host[0],
                                cuda)
        unfused = {"unfused_profile": {k: v for k, v in unfused.items()
                                       if k != "kernels"},
                   "unfused_profile_top_kernels": unfused["kernels"][:16]}
        del ustate
        gc_collect()
    result = {
        "path": path,
        "model": f"imagenet ResNet-{cfg.model.resnet_size} {size}x{size} "
                 f"fused_blocks=on fused_epilogue=on use_pallas_xent=on "
                 f"{cfg.model.compute_dtype}, B={TRAIN_BATCH}",
        "params": params, "f32_step_vs_plain": compared,
        "steps": IMAGENET_STEPS, "batches": IMAGENET_BATCHES,
        "steps_per_call": per_call, "capture_seconds": capture_seconds,
        "train_seconds": seconds,
        "loop_ms_per_step_first_included": 1e3 * seconds / IMAGENET_STEPS,
        "launches": counts, "launches_per_step": PER_PASS[path],
        "eval_launches": {k: 0 for k in KERNELS},
        "loss_first5_mean": first5, "loss_last5_mean": last5,
        "losses": losses,
        "profile": {k: v for k, v in prof.items() if k != "kernels"},
        "profile_top_kernels": prof["kernels"][:16], **unfused,
        "gpu": gpu}
    emit("train", **result)
    return result


def _peak_profile(state, step_fn, batch, cuda) -> dict:
    """The eager step's profile over IMAGENET34_PROFILE_STEPS steps of one
    seeded batch, with the device memory's peak over them (``peak_gb``:
    state, batch and the steps' own tensors)."""
    from tpu_resnet_torch.tools.profiling import (device_batches,
                                                  profile_train_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = profile_train_step(state, step_fn, device_batches(*batch, cuda),
                              iters=IMAGENET34_PROFILE_STEPS, warmup=2)
    prof["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return prof


# The chunked_train phase: each path trained twice eagerly
# (train.steps_per_call=1, the second the control) and once in chunks of
# CHUNK_PER_CALL CUDA graph replays, from the same seeded state over the
# same steps, log and checkpoint every CHUNK_LOG_EVERY[path] steps; the
# ImageNet path's seeded batches (IMAGENET_BATCHES, on the card) stand in
# for the decode engine. Then the streamed CIFAR run (fused) at
# STREAM_STAGE with the double buffer on and off, against a stage of 1.
CHUNK_PER_CALL = 10
CHUNK_PATHS = {
    "cifar10_train": ("cifar10", [*TRAIN_OVERRIDES], 50),
    "cifar10_fused_train": ("cifar10", [*TRAIN_OVERRIDES,
                                        "model.fused_blocks=true"], 50),
    "imagenet_fused_train": ("imagenet", [*IMAGENET_OVERRIDES], 30),
}
CHUNK_LOG_EVERY = {"cifar10_train": 25, "cifar10_fused_train": 25,
                   "imagenet_fused_train": 10}
CHUNK_CHECKPOINT_EVERY = {"cifar10_train": 25, "cifar10_fused_train": 25,
                          "imagenet_fused_train": 100}
CHUNK_PROFILE_STEPS = 10
STREAM_STEPS, STREAM_LOG_EVERY, STREAM_STAGE = 50, 10, 8
# Launches of one wrapper call on the fused CIFAR train path, as the
# profiler counts kernels (``tools/profiling.py`` TRAIN_KERNELS): block_fwd
# from the stats' c1 one, block_stats two, block_bwd1 two, block_bwd2
# three, block_bwd3, sbr, sbr_bwd and the xent pair one.
LAUNCHES_PER_CALL = {"sbr": 1, "sbr_bwd": 1, "xent_fwd": 1, "xent_bwd": 1,
                     "block_fwd": 1, "block_stats": 2, "block_bwd1": 2,
                     "block_bwd2": 3, "block_bwd3": 1}
# torch.optim.SGD stepped with a tensor learning rate inside a capture, in
# a process of its own: does it read the rate on the host?
SGD_TENSOR_LR_PROBE = """
import torch
p = torch.nn.Parameter(torch.ones(1024, device="cuda"))
p.grad = torch.ones_like(p)
opt = torch.optim.SGD([p], lr=torch.tensor(0.1, device="cuda"), momentum=0.9)
opt.step()
opt.step()
torch.cuda.synchronize()
graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
try:
    with torch.cuda.graph(graph, stream=stream):
        opt.step()
    print("captured")
except Exception as e:
    print(f"capture failed: {type(e).__name__}: {str(e)[:300]}")
"""


def sgd_tensor_lr_probe() -> str:
    out = subprocess.run([sys.executable, "-c", SGD_TENSOR_LR_PROBE],
                         capture_output=True, text=True, timeout=300)
    return (out.stdout.strip() or out.stderr.strip()[-300:]
            or f"exit {out.returncode}")


def state_tensors(state, recs) -> dict:
    """A run's end state by name: parameters, BN statistics, momentum
    buffers, and its logged metrics."""
    out = {f"state {n}": t for n, t in state.model.state_dict().items()}
    out.update({f"momentum {n}": t
                for n, t in state.momentum_buffers().items()})
    out.update(metric_tensors(recs))
    return out


def metric_tensors(recs) -> dict:
    """A run's logged metrics by name, as :func:`state_tensors` holds
    them."""
    return {f"metric {k}@{r['step']}": torch.tensor(r[k], dtype=torch.float64)
            for r in recs
            for k in ("loss", "precision", "learning_rate", "grad_norm")}


def run_distance(got: dict, want: dict) -> dict:
    """Normwise ‖got − want‖ / ‖want‖ per tensor: the worst, the tensors
    that differ at all, and whether every one is bit for bit equal."""
    check(set(got) == set(want), "the runs hold different tensors")
    rel = {}
    for name, w in want.items():
        g = got[name].double().cpu()
        w = w.double().cpu()
        rel[name] = float((g - w).norm() / max(float(w.norm()), 1e-30))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    equal = all(torch.equal(got[n].cpu(), want[n].cpu()) for n in want)
    return {"bit_equal": equal, "worst_rel": worst[0][1],
            "tensors_differing": sum(v > 0 for v in rel.values()),
            "tensors": len(rel), "worst_tensors": worst[:4]}


@contextlib.contextmanager
def seeded_device_stream(batches):
    """Route the loop's ImageNet ``data.train_batches`` to seeded batches
    already on the card, cycled from the requested step (what the decode
    engine hands the step)."""
    from tpu_resnet_torch import data as data_lib
    real = data_lib.train_batches

    def seeded(data_cfg, local_batch, seed=0, start_step=0, **kwargs):
        return (batches[i % len(batches)]
                for i in itertools.count(start_step))

    data_lib.train_batches = seeded
    try:
        yield
    finally:
        data_lib.train_batches = real


def chunk_arm(path: str, counters, per_call: int, seeded,
              profiled: bool = True) -> dict:
    """One arm of the chunked_train phase: ``train()`` on ``path`` at
    ``train.steps_per_call=per_call``; its metrics, checkpoints, launch
    counts, loop speed over the steps after the first log interval, peak
    memory and capture seconds, then (``profiled``) its dispatch profiled
    on its own end state, with the counters' launches over the profile."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.data.cifar import synthetic_data
    from tpu_resnet_torch.data.device_data import ChunkRunner
    from tpu_resnet_torch.tools.profiling import (device_batches,
                                                  profile_train_chunks,
                                                  profile_train_step)
    from tpu_resnet_torch.train import checkpoint
    from tpu_resnet_torch.train.loop import make_loop_step, train

    preset, overrides, steps = CHUNK_PATHS[path]
    log_every = CHUNK_LOG_EVERY[path]
    cuda = torch.device("cuda")
    train_dir = tempfile.mkdtemp(prefix=f"chip_smoke_chunk_{path}_")
    try:
        cfg = load_config(preset, "", [
            *overrides, f"train.train_dir={train_dir}",
            f"train.train_steps={steps}", f"train.log_every={log_every}",
            f"train.checkpoint_every={CHUNK_CHECKPOINT_EVERY[path]}",
            f"train.steps_per_call={per_call}"])
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        t0 = time.monotonic()
        with (seeded_device_stream(seeded) if preset == "imagenet"
              else contextlib.nullcontext()):
            state = train(cfg, device="cuda")
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        counts = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        check(state.step == steps, f"{path}: train() stopped at {state.step}")
        want = {k: n * steps for k, n in PER_PASS[path].items()}
        check(counts == want, f"{path} steps_per_call={per_call}: launch "
              f"counts {counts}, expected {want}")
        with open(os.path.join(train_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        saved = checkpoint.all_steps_in(train_dir)
        tensors = {n: t.detach().clone()
                   for n, t in state_tensors(state, recs).items()}
        if preset == "imagenet":
            images, labels = (t.cpu().numpy() for t in seeded[0])
        else:
            images, labels = synthetic_data(TRAIN_BATCH, 32,
                                            cfg.data.num_classes,
                                            learnable=True)
        step_fn = make_loop_step(cfg, cuda)
        prof, runner, profiled_counts = {}, None, None
        zero_counts(counters)
        before = state.step
        if profiled and per_call == 1:
            prof = profile_train_step(state, step_fn,
                                      device_batches(images, labels, cuda),
                                      iters=CHUNK_PROFILE_STEPS)
        elif profiled:
            runner = ChunkRunner(step_fn, cuda, per_call)
            prof = profile_train_chunks(
                state, runner, device_batches(images, labels, cuda),
                per_call, chunks=CHUNK_PROFILE_STEPS // per_call)
        if profiled:
            torch.cuda.synchronize()
            walked = max(1, state.step - before)
            profiled_counts = {k: n / walked
                               for k, n in read_counts(counters).items()}
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    first, last = recs[0], recs[-1]
    window_steps = last["step"] - first["step"]
    wall = last["wall"] - first["wall"]
    arm = {"steps_per_call": per_call, "steps": steps,
           "train_seconds": seconds,
           "logged_steps": [r["step"] for r in recs],
           "checkpoints": saved, "launches": counts,
           "loop_window_steps": window_steps, "loop_window_s": wall,
           "loop_ms_per_step": 1e3 * wall / window_steps,
           "loop_images_per_s": TRAIN_BATCH * window_steps / wall,
           "capture_seconds": next((r["capture_seconds"] for r in recs
                                    if "capture_seconds" in r), None),
           "max_memory_allocated_bytes": peak,
           "losses": {str(r["step"]): r["loss"] for r in recs},
           "profile": {k: v for k, v in prof.items() if k != "kernels"},
           "profile_top_kernels": prof.get("kernels", [])[:8]}
    return {"arm": arm, "tensors": tensors, "runner": runner,
            "profiled_counts": profiled_counts}


def profiler_window(arm: dict) -> dict:
    """The runner's counted launches a step against the profiler's kernels
    a step over the graphed fused CIFAR arm's profiled window (counts are
    wrapper calls, times each call's launches)."""
    counted, kernels = arm["profiled_counts"], arm["arm"]["profile"][
        "port_kernels"]
    out = {name: {"counted": counted[name] * per,
                  "profiled": round(kernels[name]["launches_per_step"], 3)}
           for name, per in LAUNCHES_PER_CALL.items()}
    short = {k: v for k, v in out.items() if v["profiled"] < v["counted"]}
    return {"steps": CHUNK_PROFILE_STEPS, "launches_per_step": out,
            "profiler_short": short}


def streamed_arms(counters) -> dict:
    """The fused CIFAR path streamed from the host
    (``data.device_resident=off``), graphed: STREAM_STEPS steps at a stage
    of STREAM_STAGE with the double buffer on and off, and at a stage of 1;
    every batch the steps read and the loss stream bit for bit equal across
    the three, and the double buffer's h2d stats."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.data import device_data
    from tpu_resnet_torch.train.loop import train

    arms = {"stage8_double_buffer": (STREAM_STAGE, "true"),
            "stage8_generator": (STREAM_STAGE, "false"),
            "stage1": (1, "true")}
    real = device_data.ChunkRunner._run
    out, fed = {}, {}

    def tapped(self, state, c, batch_at):
        def at(i):
            images, labels = batch_at(i)
            fed[arm].append((images.clone(), labels.clone()))
            return images, labels
        return real(self, state, c, at)

    device_data.ChunkRunner._run = tapped
    try:
        for arm, (stage, double) in arms.items():
            fed[arm] = []
            train_dir = tempfile.mkdtemp(prefix=f"chip_smoke_stream_{arm}_")
            try:
                cfg = load_config("cifar10", "", [
                    *CHUNK_PATHS["cifar10_fused_train"][1],
                    "data.device_resident=off",
                    f"data.transfer_stage={stage}",
                    f"data.h2d_double_buffer={double}",
                    f"train.train_dir={train_dir}",
                    f"train.train_steps={STREAM_STEPS}",
                    f"train.log_every={STREAM_LOG_EVERY}",
                    f"train.checkpoint_every={STREAM_STEPS}",
                    f"train.steps_per_call={CHUNK_PER_CALL}"])
                zero_counts(counters)
                t0 = time.monotonic()
                state = train(cfg, device="cuda")
                torch.cuda.synchronize()
                seconds = time.monotonic() - t0
                counts = read_counts(counters)
                with open(os.path.join(train_dir, "metrics.jsonl")) as f:
                    recs = [json.loads(line) for line in f]
            finally:
                shutil.rmtree(train_dir, ignore_errors=True)
            want = {k: n * STREAM_STEPS for k, n in
                    PER_PASS["cifar10_fused_train"].items()}
            check(state.step == STREAM_STEPS and counts == want,
                  f"streamed {arm}: step {state.step}, launches {counts}")
            del state
            wall = recs[-1]["wall"] - recs[0]["wall"]
            steps = recs[-1]["step"] - recs[0]["step"]
            out[arm] = {
                "transfer_stage": stage, "h2d_double_buffer": double,
                "train_seconds": seconds,
                "loop_ms_per_step": 1e3 * wall / steps,
                "loop_images_per_s": TRAIN_BATCH * steps / wall,
                "losses": [r["loss"] for r in recs],
                "h2d": [{k: r[k] for k in ("step", "h2d_bytes_per_sec",
                                           "h2d_overlap_frac")}
                        for r in recs if "h2d_bytes_per_sec" in r]}
    finally:
        device_data.ChunkRunner._run = real
    base = fed["stage1"]
    for arm in arms:
        check(len(fed[arm]) == STREAM_STEPS, f"streamed {arm}: "
              f"{len(fed[arm])} batches for {STREAM_STEPS} steps")
        differ = [i for i, ((a, b), (c, d)) in enumerate(zip(fed[arm], base))
                  if not (torch.equal(a, c) and torch.equal(b, d))]
        check(not differ, f"streamed {arm}: batches {differ[:8]} differ "
              f"from the stage-1 stream's")
        check(out[arm]["losses"] == out["stage1"]["losses"],
              f"streamed {arm}: losses {out[arm]['losses']} against "
              f"{out['stage1']['losses']}")
        out[arm]["batches_equal"] = len(fed[arm])
    check(out["stage8_double_buffer"]["h2d"], "no h2d stats logged")
    return out


def gc_collect() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def chunked_train_phase(counters, gpu: str) -> dict:
    """Multi-step dispatch on the card (``train.steps_per_call``): per
    path of ``CHUNK_PATHS``, two eager runs and one in chunks of CUDA graph
    replays from the same seeded state over the same steps. The graphed
    run's end state (parameters, BN statistics, momentum buffers) and
    logged metrics are bit for bit the eager run's where the two eager
    runs are, else within ``CONTROL_FACTOR`` times the control's normwise
    distance; every run's launch counts are exact (``PER_PASS`` a step);
    all write the same metrics.jsonl steps and checkpoints. Each arm's
    loop speed, device busy time and idle share, capture seconds and peak
    memory; the counters against the profiler over a graphed window of the
    fused CIFAR path; the streamed runs (``streamed_arms``); and whether
    ``torch.optim.SGD`` can be captured with a tensor learning rate.
    Returns the graphed fused CIFAR arm (its end state and figures), the
    run without a process group that the data_parallel phase's part (a)
    holds its grouped run against."""
    from tpu_resnet_torch.ops import epilogue as ep

    paths = {}
    window_check = fused_graphed = None
    for path, (preset, _, steps) in CHUNK_PATHS.items():
        seeded = None
        if preset == "imagenet":
            cuda = torch.device("cuda")
            seeded = [(torch.from_numpy(im).to(cuda),
                       torch.from_numpy(lb).to(cuda)) for im, lb in
                      imagenet_batches(IMAGENET_BATCHES, TRAIN_BATCH, 1000,
                                       224)]
        runs = {}
        for name, per_call in (("eager", 1), ("eager_control", 1),
                               ("graphed", CHUNK_PER_CALL)):
            runs[name] = chunk_arm(path, counters, per_call, seeded,
                                   profiled=name != "eager_control")
            runner = runs[name].pop("runner")
            if runner is not None:
                tickets = [t for key, t in ep._bwd_tickets.items()
                           if key[1] == runner._stream.cuda_stream]
                check(len(tickets) == 1 and not tickets[0].any(),
                      f"{path}: sbr_bwd's capture-stream tickets "
                      f"{[t.nonzero().numel() for t in tickets]}")
                if path == "cifar10_fused_train":
                    window_check = profiler_window(runs[name])
                    fused_graphed = runs[name]
                runner.close()
            gc_collect()
        eager = runs["eager"]
        control = run_distance(runs["eager_control"]["tensors"],
                               eager["tensors"])
        graphed = run_distance(runs["graphed"]["tensors"], eager["tensors"])
        if control["bit_equal"]:
            ok = graphed["bit_equal"]
        else:
            ok = (graphed["worst_rel"]
                  <= CONTROL_FACTOR * control["worst_rel"])
        check(ok, f"{path}: graphed against eager {graphed}, control "
              f"{control}")
        arms = {name: r["arm"] for name, r in runs.items()}
        for name in ("eager_control", "graphed"):
            for key in ("logged_steps", "checkpoints"):
                check(arms[name][key] == arms["eager"][key],
                      f"{path} {name}: {key} {arms[name][key]}, eager "
                      f"{arms['eager'][key]}")
        paths[path] = {"steps": steps, "log_every": CHUNK_LOG_EVERY[path],
                       "graphed_vs_eager": graphed,
                       "control_vs_eager": control,
                       "control_factor": CONTROL_FACTOR, "arms": arms}
    streamed = streamed_arms(counters)
    result = {"steps_per_call": CHUNK_PER_CALL, "paths": paths,
              "profiler_window": window_check, "streamed": streamed,
              "sgd_tensor_lr_capture": sgd_tensor_lr_probe(), "gpu": gpu}
    emit("chunked_train", **result)
    return fused_graphed


# The observability phase: ImageNet ResNet-50 fused, graphed, on seeded
# batches on the card (the decode engine's place), and CIFAR-10 ResNet-50
# fused, graphed (OBS_PATHS), each with observability on (telemetry on an
# ephemeral port, scraped from a thread during the run; the FLOPs and
# memory ledgers; the watchdog) and off; then the fault drills on the
# CIFAR-10 ResNet-50 fused path, graphed, at full depth (DRILL_* below).
OBS_LOG_EVERY, OBS_WATCHDOG_SEC = 10, 600
OBS_PATHS = {  # path: (preset, overrides, steps)
    "imagenet_fused_train": ("imagenet", [
        *IMAGENET_OVERRIDES, f"train.global_batch_size={TRAIN_BATCH}"], 30),
    "cifar10_fused_train": ("cifar10", [*TRAIN_OVERRIDES,
                                        "model.fused_blocks=true"], 100)}
OBS_ON = ["train.telemetry_port=0", "train.mfu_accounting=true",
          "train.memory_ledger=true",
          f"resilience.watchdog_stall_sec={OBS_WATCHDOG_SEC}"]
OBS_OFF = ["train.telemetry_port=-1", "train.mfu_accounting=false",
           "train.memory_ledger=false", "resilience.watchdog_stall_sec=0"]
MFU_RTOL = 1e-6
MEMORY_RTOL = 0.05
# The graphed ImageNet run's peak device memory before this phase existed
# (PERF.md §5, the chunked_train table), printed beside this phase's.
MEMORY_BEFORE = "6.33-6.39 GB (PERF.md 5, chunked_train, graphed ImageNet)"
OBS_GAUGES = ("step", "images_per_sec", "mfu", "model_flops_per_sec",
              "hbm_bytes_in_use", "hbm_bytes_peak", "hbm_bytes_limit",
              "hbm_utilization")
DRILL_OVERRIDES = [*TRAIN_OVERRIDES, "model.fused_blocks=true",
                   "train.mfu_accounting=false", "train.memory_ledger=false",
                   "resilience.watchdog_stall_sec=0",
                   f"train.steps_per_call={CHUNK_PER_CALL}"]
DRILL_STALL = dict(steps=80, at=40, seconds=3.0, watchdog=1.0)
DRILL_STEPS, DRILL_SIGTERM_AT = 60, 30


def scrape_loop(train_dir: str, stop, out: list) -> None:
    """Scrape ``/metrics`` and ``/healthz`` of the run in ``train_dir``
    every 50 ms until ``stop`` is set (``obs.scrape``), with the wall time
    of each scrape."""
    from tpu_resnet_torch import obs

    while not stop.is_set():
        port = obs.read_telemetry_port(train_dir)
        if port:
            try:
                got = obs.scrape(f"127.0.0.1:{port}", timeout=2)
                out.append({"wall": time.time(), **got})
            except (OSError, ValueError):
                pass
        stop.wait(0.05)


@contextlib.contextmanager
def scraping(train_dir: str):
    """Scrape the run in ``train_dir`` from a thread while the block runs;
    yields the list the scrapes land in."""
    scrapes, stop = [], threading.Event()
    thread = threading.Thread(target=scrape_loop,
                              args=(train_dir, stop, scrapes), daemon=True)
    thread.start()
    try:
        yield scrapes
    finally:
        stop.set()
        thread.join()


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def obs_arm(path: str, counters, seeded, on: bool) -> dict:
    """One run of ``OBS_PATHS[path]`` in the observability phase."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.obs.spans import load_spans
    from tpu_resnet_torch.train.loop import train

    preset, overrides, steps = OBS_PATHS[path]
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        cfg = load_config(preset, "", [
            *overrides, f"train.train_dir={train_dir}",
            f"train.train_steps={steps}", f"train.log_every={OBS_LOG_EVERY}",
            f"train.checkpoint_every={steps}",
            f"train.steps_per_call={CHUNK_PER_CALL}",
            *(OBS_ON if on else OBS_OFF)])
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        with (seeded_device_stream(seeded) if preset == "imagenet"
              else contextlib.nullcontext()), (
                scraping(train_dir) if on
                else contextlib.nullcontext([])) as scrapes:
            state = train(cfg, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        recs = read_jsonl(os.path.join(train_dir, "metrics.jsonl"))
        spans = load_spans(os.path.join(train_dir, "events.jsonl"))
        files = {name: json.load(open(os.path.join(train_dir, name)))
                 for name in ("flops.json", "memory.json", "manifest.json")
                 if os.path.exists(os.path.join(train_dir, name))}
        tensors = {n: t.detach().clone()
                   for n, t in state_tensors(state, recs).items()}
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    want = {k: n * steps for k, n in PER_PASS[path].items()}
    check(state.step == steps and counts == want,
          f"observability {path} on={on}: step {state.step}, launches "
          f"{counts}, expected {want}")
    del state
    window = recs[-1]["step"] - recs[0]["step"]
    return {"on": on, "counts": counts, "peak": peak, "recs": recs,
            "spans": spans, "files": files, "tensors": tensors,
            "scrapes": scrapes,
            "loop_ms_per_step": 1e3 * (recs[-1]["wall"] - recs[0]["wall"])
            / window}


def obs_checks(arm: dict, kind: str) -> dict:
    """The obs-on run: gauges present and finite in a scrape after a rate
    was logged, mfu = FLOPs × steps/s ÷ peak, the memory ledger against
    the allocator's peak, the spans."""
    from tpu_resnet_torch.obs import mfu

    scrapes = arm["scrapes"]
    check(bool(scrapes), "observability: no scrape reached the run")
    rated = [s for s in scrapes
             if s["metrics"].get("tpu_resnet_images_per_sec", 0) > 0]
    check(bool(rated), f"observability: no scrape after a logged rate "
          f"({len(scrapes)} scrapes)")
    last = rated[-1]
    gauges = {g: last["metrics"].get(f"tpu_resnet_{g}") for g in OBS_GAUGES}
    check(all(v is not None and np.isfinite(v) for v in gauges.values()),
          f"observability: gauges {gauges}")
    check(last["health_status"] == 200 and last["health"]["ok"],
          f"observability: /healthz {last['health_status']}")
    check(all(s["health_status"] == 200 for s in scrapes),
          "observability: /healthz not 200 during the run")
    ((key, flops_entry),) = arm["files"]["flops.json"]["entries"].items()
    flops = flops_entry["flops_per_step"]
    peak_flops = mfu.peak_flops_per_chip(kind)
    check(peak_flops is not None, f"no peak for {kind!r}")
    final = arm["recs"][-1]
    want_mfu = flops * final["steps_per_sec"] / peak_flops
    mfu_rel = abs(final["mfu"] - want_mfu) / want_mfu
    m = last["metrics"]
    gauge_rel = abs(m["tpu_resnet_mfu"] - flops * m["tpu_resnet_steps_per_sec"]
                    / peak_flops) / m["tpu_resnet_mfu"]
    check(mfu_rel <= MFU_RTOL and gauge_rel <= MFU_RTOL,
          f"mfu {final['mfu']} (gauge {m['tpu_resnet_mfu']}) against "
          f"flops x steps/s / peak: rel {mfu_rel}, {gauge_rel}")
    ((mkey, mem),) = arm["files"]["memory.json"]["entries"].items()
    mem_rel = abs(mem["peak_bytes"] - arm["peak"]) / arm["peak"]
    check(mkey == key and mem_rel <= MEMORY_RTOL,
          f"memory.json peak {mem['peak_bytes']} against the allocator's "
          f"{arm['peak']}: rel {mem_rel}")
    kinds = [s["span"] for s in arm["spans"]]
    check(kinds[:3] == ["compile", "mfu_account", "memory_account"]
          and kinds[-1] == "run" and "checkpoint_save" in kinds,
          f"observability: spans {kinds}")
    return {"program_key": key, "flops_per_step": flops,
            "flops_source": flops_entry["flops_source"],
            "peak_flops_per_chip": peak_flops,
            "mfu": final["mfu"], "mfu_expected": want_mfu,
            "mfu_rel_err": mfu_rel, "gauge_mfu_rel_err": gauge_rel,
            "model_flops_per_sec": final["model_flops_per_sec"],
            "steps_per_sec": final["steps_per_sec"],
            "memory_json": mem, "max_memory_allocated_bytes": arm["peak"],
            "memory_rel_err": mem_rel, "memory_before": MEMORY_BEFORE,
            "scrapes": len(scrapes), "scraped_gauges": gauges,
            "scraped_step": m["tpu_resnet_step"],
            "train_step_ms": last["histograms"].get(
                "tpu_resnet_train_step_ms"),
            "breakdown": {r["step"]: {k: r.get(k) for k in (
                "data_wait_sec", "data_wait_frac", "dispatch_sec",
                "device_sync_sec", "device_step_sec_sampled",
                "compile_seconds", "capture_seconds", "train_step_ms_p50",
                "hbm_bytes_in_use", "hbm_bytes_peak")}
                for r in arm["recs"]},
            "spans": kinds}


def drill_cfg(train_dir: str, steps: int, *extra):
    from tpu_resnet_torch.config import load_config
    return load_config("cifar10", "", [
        *DRILL_OVERRIDES, f"train.train_dir={train_dir}",
        f"train.train_steps={steps}", *extra])


def stall_drill() -> dict:
    """The streamed path (the injector wraps host batches): a
    ``DRILL_STALL`` stall against the watchdog's deadline; /healthz 503
    during it and 200 after it, the stack dump, both watchdog spans."""
    from tpu_resnet_torch.obs.spans import load_spans
    from tpu_resnet_torch.train.loop import train

    s = DRILL_STALL
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_drill_stall_")
    try:
        cfg = drill_cfg(train_dir, s["steps"], "data.device_resident=off",
                        "data.transfer_stage=1", "train.telemetry_port=0",
                        f"resilience.watchdog_stall_sec={s['watchdog']}",
                        f"resilience.inject_stall_at_step={s['at']}",
                        f"resilience.inject_stall_seconds={s['seconds']}")
        t0 = time.monotonic()
        with scraping(train_dir) as scrapes:
            state = train(cfg, device="cuda")
        seconds = time.monotonic() - t0
        spans = load_spans(os.path.join(train_dir, "events.jsonl"))
        dumps = sorted(os.path.basename(p) for p in os.listdir(train_dir)
                       if p.startswith("stall_stacks_"))
        with open(os.path.join(train_dir, dumps[0])) as f:
            dump_has_main = "MainThread" in f.read()
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    stalls = [x for x in spans if x["span"] == "watchdog_stall"]
    recovered = [x for x in spans if x["span"] == "watchdog_recovered"]
    codes = [x["health_status"] for x in scrapes]
    first_503 = codes.index(503) if 503 in codes else None
    check(state.step == s["steps"] and len(stalls) == 1
          and len(recovered) == 1 and dump_has_main
          and first_503 is not None and 200 in codes[first_503:]
          and 200 in codes[:first_503],
          f"stall drill: step {state.step}, stalls {stalls}, recovered "
          f"{recovered}, dumps {dumps}, /healthz {codes}")
    reason = next(x["health"].get("unhealthy_reason") for x in scrapes
                  if x["health_status"] == 503)
    return {"steps": s["steps"], "stall_at": s["at"],
            "stall_seconds": s["seconds"], "watchdog_sec": s["watchdog"],
            "seconds": seconds, "stall_step": stalls[0]["step"],
            "outage_sec": recovered[0]["outage_sec"], "dumps": dumps,
            "healthz_503": codes.count(503), "healthz_200": codes.count(200),
            "unhealthy_reason": reason}


def sigterm_and_corrupt_drills() -> dict:
    """SIGTERM at ``DRILL_SIGTERM_AT``: ``Preempted`` at that boundary with
    its checkpoint, then a resume to ``DRILL_STEPS`` against the
    uninterrupted run, bit for bit (else within ``CONTROL_FACTOR`` times a
    second uninterrupted run's distance). Then the uninterrupted run's dir
    resumed with ``resilience.inject_corrupt_ckpt``: its newest checkpoint
    fails, the restore falls back to the one before."""
    from tpu_resnet_torch.obs.spans import load_spans
    from tpu_resnet_torch.resilience.shutdown import Preempted
    from tpu_resnet_torch.train import checkpoint
    from tpu_resnet_torch.train.loop import train

    every = f"train.checkpoint_every={DRILL_SIGTERM_AT}"
    dirs = [tempfile.mkdtemp(prefix=f"chip_smoke_drill_{n}_")
            for n in ("sigterm", "whole", "control")]
    try:
        cut, whole, control = dirs
        t0 = time.monotonic()
        try:
            train(drill_cfg(cut, DRILL_STEPS, every,
                            f"resilience.inject_sigterm_at_step="
                            f"{DRILL_SIGTERM_AT}"), device="cuda")
            preempted = None
        except Preempted as e:
            preempted = e.step
        saved = checkpoint.all_steps_in(cut)
        stop = [x for x in load_spans(os.path.join(cut, "events.jsonl"))
                if x["span"] == "preempt_stop"]
        resumed = train(drill_cfg(cut, DRILL_STEPS, every), device="cuda")
        got = {n: t.detach().clone() for n, t in state_tensors(
            resumed, read_jsonl(os.path.join(cut, "metrics.jsonl"))[-1:]
        ).items()}
        del resumed
        gc_collect()
        base = train(drill_cfg(whole, DRILL_STEPS, every), device="cuda")
        want = {n: t.detach().clone() for n, t in state_tensors(
            base, read_jsonl(os.path.join(whole, "metrics.jsonl"))[-1:]
        ).items()}
        del base
        gc_collect()
        dist = run_distance(got, want)
        control_dist = None
        if not dist["bit_equal"]:
            ctl = train(drill_cfg(control, DRILL_STEPS, every), device="cuda")
            control_dist = run_distance({n: t.detach().clone() for n, t in
                                         state_tensors(ctl, read_jsonl(
                                             os.path.join(control,
                                                          "metrics.jsonl")
                                         )[-1:]).items()}, want)
            del ctl
        sigterm_s = time.monotonic() - t0
        check(preempted == DRILL_SIGTERM_AT and saved == [DRILL_SIGTERM_AT]
              and len(stop) == 1 and stop[0]["step"] == DRILL_SIGTERM_AT,
              f"sigterm drill: preempted at {preempted}, checkpoints "
              f"{saved}, spans {stop}")
        check(dist["bit_equal"] or (
            control_dist is not None and dist["worst_rel"]
            <= CONTROL_FACTOR * control_dist["worst_rel"]),
              f"sigterm drill: resumed against uninterrupted {dist}, "
              f"control {control_dist}")
        gc_collect()
        t0 = time.monotonic()
        state = train(drill_cfg(whole, DRILL_STEPS, every,
                                "resilience.inject_corrupt_ckpt=true"),
                      device="cuda")
        corrupt_s = time.monotonic() - t0
        spans = load_spans(os.path.join(whole, "events.jsonl"))
        failed = [x["step"] for x in spans
                  if x["span"] == "checkpoint_restore_failed"]
        restored = [x for x in spans if x["span"] == "checkpoint_restore"]
        check(failed == [DRILL_STEPS] and len(restored) == 1
              and restored[0]["step"] == DRILL_SIGTERM_AT
              and state.step == DRILL_STEPS,
              f"corrupt drill: failed {failed}, restored {restored}, step "
              f"{state.step}")
        del state
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    return {"sigterm": {"at": DRILL_SIGTERM_AT, "steps": DRILL_STEPS,
                        "preempted_at": preempted, "checkpoints": saved,
                        "resumed_vs_whole": dist,
                        "control_vs_whole": control_dist,
                        "seconds": sigterm_s},
            "corrupt_checkpoint": {"failed": failed,
                                   "restored": restored[0]["step"],
                                   "seconds": corrupt_s}}


def oom_drill() -> dict:
    """``resilience.inject_oom_at_step``: the synthetic RESOURCE_EXHAUSTED
    at a chunk boundary, and an ``oom_report.json`` that passes
    ``validate_oom_report``, with the allocator's stats."""
    from tpu_resnet_torch.obs import memory
    from tpu_resnet_torch.train.loop import train

    at = 20
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_drill_oom_")
    try:
        cfg = drill_cfg(train_dir, 40, "train.memory_ledger=true",
                        f"resilience.inject_oom_at_step={at}")
        err = None
        try:
            train(cfg, device="cuda")
        except RuntimeError as e:
            err = str(e)
        with open(os.path.join(train_dir, "oom_report.json")) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    problems = memory.validate_oom_report(report)
    stats = (report["devices"][0]["stats"] or {})
    check(err is not None and "RESOURCE_EXHAUSTED" in err and not problems
          and report["step"] == at and stats.get("allocated_bytes.all.peak"),
          f"oom drill: error {err}, report problems {problems}, step "
          f"{report.get('step')}")
    return {"at": at, "problems": problems,
            "live_tensors": report["live_arrays"]["total_arrays"],
            "live_bytes": report["live_arrays"]["total_bytes"],
            "allocator_peak_bytes": stats["allocated_bytes.all.peak"],
            "program_key": report["program_key"]}


def obs_path(path: str, counters, seeded, kind: str) -> dict:
    """``path`` with observability on and off (``obs_arm``,
    ``obs_checks``): launches exact in both, the end state and the
    loss/precision metrics of the two bit for bit, both runs' loop
    ms/step."""
    on = obs_arm(path, counters, seeded, True)
    checks = obs_checks(on, kind)
    gc_collect()
    off = obs_arm(path, counters, seeded, False)
    gc_collect()
    keys = ("step", "loss", "precision")
    same_metrics = ([{k: r[k] for k in keys} for r in on["recs"]]
                    == [{k: r[k] for k in keys} for r in off["recs"]])
    dist = run_distance(off["tensors"], on["tensors"])
    check(dist["bit_equal"] and same_metrics,
          f"observability {path} off against on: {dist}, metrics "
          f"{same_metrics}")
    return {"steps": OBS_PATHS[path][2], "launches": on["counts"],
            **checks, "max_memory_allocated_bytes_off": off["peak"],
            "off_vs_on": dist, "metrics_equal": same_metrics,
            "loop_ms_per_step_on": on["loop_ms_per_step"],
            "loop_ms_per_step_off": off["loop_ms_per_step"],
            "loop_ms_per_step_on_minus_off": (on["loop_ms_per_step"]
                                              - off["loop_ms_per_step"])}


def observability_phase(counters, gpu: str) -> dict:
    """``obs_path`` on ImageNet ResNet-50 fused and graphed (seeded
    batches on the card) and on CIFAR-10 ResNet-50 fused and graphed; then
    the drills on the CIFAR path."""
    cuda = torch.device("cuda")
    seeded = [(torch.from_numpy(im).to(cuda), torch.from_numpy(lb).to(cuda))
              for im, lb in imagenet_batches(IMAGENET_BATCHES, TRAIN_BATCH,
                                             1000, 224)]
    kind = torch.cuda.get_device_name(0)
    imagenet = obs_path("imagenet_fused_train", counters, seeded, kind)
    del seeded
    gc_collect()
    cifar = obs_path("cifar10_fused_train", counters, None, kind)
    drills = {"path": "cifar10 ResNet-50 fused, graphed, B=128, depth not "
                      "cut",
              "stall": stall_drill()}
    gc_collect()
    drills.update(sigterm_and_corrupt_drills())
    gc_collect()
    drills["oom"] = oom_drill()
    gc_collect()
    result = {
        "path": "imagenet_fused_train",
        "model": f"imagenet ResNet-50 224x224 fused, graphed "
                 f"(steps_per_call={CHUNK_PER_CALL}), seeded batches, "
                 f"B={TRAIN_BATCH}",
        **imagenet,
        "launches_per_step": PER_PASS["imagenet_fused_train"],
        "eval_launches": {k: 0 for k in KERNELS},
        "cifar10_fused_train": cifar, "drills": drills, "gpu": gpu}
    emit("observability", **result)
    return result


# The ImageNet input phase: JPEG shards made at run time from the committed
# fixtures' payloads (tests/fixtures/imagenet, 28 JPEGs), cycled with seeded
# labels 1..1000: INPUT_TRAIN_SHARDS of INPUT_PER_SHARD records (ten
# batches of 128) and a validation shard of INPUT_VALIDATION (two batches of
# 125, the preset's eval batch). train() runs INPUT_STEPS steps with a
# checkpoint at INPUT_RESUME_AT, from which a second run resumes.
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "imagenet")
INPUT_TRAIN_SHARDS, INPUT_PER_SHARD, INPUT_VALIDATION = 8, 160, 250
INPUT_STEPS, INPUT_RESUME_AT, INPUT_PROFILE_STEPS = 30, 20, 15
# At most this many steps fed by a fresh engine before its profiled window.
INPUT_SETTLE_MAX = 60
INPUT_OVERRIDES = [*IMAGENET_OVERRIDES,
                   f"train.global_batch_size={TRAIN_BATCH}"]
# nvJPEG against the plain decoder (data/jpeg.py, PIL's decode), per
# sampling: (max |d|, mean |d|) per image. Measured on an H100 over the 28
# fixtures (tools/time_torch_imagenet_input.py, which applies no limit):
# max 25, 16, 4, 1 and worst means 0.95, 1.14, 0.52, 0.02 at 4:2:0, 4:2:2,
# 4:4:4, grey: nvJPEG's IDCT and chroma upsampling are not libjpeg's, and
# the fixtures' detail (a texture sized to ImageNet's mean bytes) shows it.
NVJPEG_TOL = {"4:2:0": (30, 1.25), "4:2:2": (20, 1.5), "4:4:4": (6, 1.0),
              "grey": (2, 0.1)}
# The decode stage (nvJPEG + tr_resize_crop) against the plain decoder and
# the plain resize: max |d| per image and mean |d| over the batch
# (measured: 22 and 0.54; the resize averages, so the stage's max stays
# within the decode's plus a level); tr_resize_crop alone against its
# plain version on the same decoded pixels: one filter in the same float
# order.
STAGE_TOL = (28, 0.75)
RESIZE_TOL = 1


def make_input_shards(root: str) -> list:
    """Write the phase's shards under ``root``; returns the payloads."""
    from tpu_resnet_torch.data import imagenet, tfrecord
    payloads = [imagenet.parse_record(r)[0]
                for name in sorted(os.listdir(FIXTURES))
                for r in tfrecord.read_records(os.path.join(FIXTURES, name),
                                               verify_crc=True)]
    rng = np.random.default_rng(17)
    made = 0

    def records(n):
        nonlocal made
        out = [tfrecord.encode_example({
            "image/encoded": [payloads[(made + i) % len(payloads)]],
            "image/class/label": [int(rng.integers(1, 1001))]})
            for i in range(n)]
        made += n
        return out

    for s in range(INPUT_TRAIN_SHARDS):
        tfrecord.write_records(os.path.join(
            root, f"train-{s:05d}-of-{INPUT_TRAIN_SHARDS:05d}"),
            records(INPUT_PER_SHARD))
    tfrecord.write_records(os.path.join(root, "validation-00000-of-00001"),
                           records(INPUT_VALIDATION))
    return payloads


class Tap:
    """The train loop's batch stream with the batches of ``seqs`` copied
    to the host when the loop asks for the next one, that is after the
    step that read them was queued (the copy waits for it)."""

    def __init__(self, engine, first_seq: int, seqs, store: dict):
        self.engine, self.seq, self.seqs, self.store = (engine, first_seq,
                                                        seqs, store)
        self.held = None

    def _keep(self):
        if self.held is not None:
            seq, (images, labels) = self.held
            self.store[seq] = (images.cpu(), labels.cpu())
            self.held = None

    def __iter__(self):
        return self

    def __next__(self):
        self._keep()
        batch = next(self.engine)
        if self.seq in self.seqs:
            self.held = (self.seq, batch)
        self.seq += 1
        return batch

    def stats(self):
        return self.engine.stats()

    def close(self):
        self._keep()
        self.engine.close()


@contextlib.contextmanager
def tapped_stream(seqs, store: dict):
    """Route the train loop's ``data.train_batches`` through :class:`Tap`."""
    from tpu_resnet_torch import data as data_lib
    real = data_lib.train_batches

    def tapped(*args, **kwargs):
        return Tap(real(*args, **kwargs), kwargs["start_step"], seqs, store)

    data_lib.train_batches = tapped
    try:
        yield
    finally:
        data_lib.train_batches = real


def resize_bound(sizes, tables, out_size: int) -> tuple:
    """(ms, what bounds it) of tr_resize_crop on this batch: the source
    pixels its windows touch read once, the output and the tables written
    and read once, against the operations its taps do (a multiply and an
    add each, three channels) at the float32 rate."""
    first, count, weights = tables
    nbytes = first.nbytes + count.nbytes + weights.nbytes + (
        len(sizes) * out_size * out_size * 3)
    ops = 0
    for (_, _, c), f, n in zip(sizes, first, count):
        rows = int((f[0] + n[0]).max() - f[0].min())
        cols = int((f[1] + n[1]).max() - f[1].min())
        nbytes += rows * cols * c
        ops += 6 * int((n[0][:, None] * (n[1][None, :] + 1)).sum())
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def draw_params(cfg) -> dict:
    """The engine's draw parameters of ``cfg``'s training stream."""
    d = cfg.data
    return dict(train=True, seed=cfg.train.seed, resize_min=d.resize_min,
                resize_max=d.resize_max, eval_resize=d.eval_resize)


def decode_stage_measure(root: str, cfg) -> dict:
    """The decode stage on the card against its plain versions on the
    first B=128 order of the train stream, and the times of its parts; no
    limit is applied here (``decode_stage_checks`` applies them)."""
    from tpu_resnet_torch.data import engine
    from tpu_resnet_torch.data import jpeg as plain_jpeg
    from tpu_resnet_torch.data.imagenet import (ImageNetIterator,
                                                parse_record)
    from tpu_resnet_torch.ops import jpeg_decode as jd

    it = ImageNetIterator.from_config(cfg.data, TRAIN_BATCH,
                                      seed=cfg.train.seed)
    records = engine.read_order(next(it.work_orders()), it.files)
    draws = engine.order_draws(draw_params(cfg), 0, len(records))
    jpegs = [parse_record(p)[0] for p, _ in records]
    size = cfg.data.resolved_image_size
    stage = engine.DecodeStage(torch.device("cuda"), size, TRAIN_BATCH)
    try:
        images, _, _ = stage.batch(records, draws)
        torch.cuda.synchronize()
        card = images.cpu().numpy().astype(np.int16)
        # nvJPEG alone, per distinct JPEG, against the plain decoder.
        distinct = list(dict.fromkeys(jpegs))
        src, offsets, sizes = stage.decoder.decode_batch(distinct)
        plain_rgb, by_sampling = {}, {}
        t0 = time.perf_counter()
        for data in distinct:
            plain_rgb[data] = plain_jpeg.decode(data)
        plain_decode_ms = 1e3 * (time.perf_counter() - t0) / len(distinct)
        for data, off, (w, h, c) in zip(distinct, offsets.tolist(), sizes):
            got = src[off:off + w * h * c].view(h, w, c).cpu().numpy()
            diff = np.abs(got.astype(np.int16)
                          - plain_rgb[data][..., :c].astype(np.int16))
            by_sampling.setdefault(plain_jpeg.sampling(data), []).append(
                (int(diff.max()), float(diff.mean())))
        nvjpeg = {s: {"images": len(v), "max_abs": max(m for m, _ in v),
                      "mean_abs": max(a for _, a in v)}
                  for s, v in sorted(by_sampling.items())}
        # The whole stage against the plain decoder and the plain resize.
        plain = np.stack([jd.resize_crop_reference(
            torch.from_numpy(plain_rgb[data]),
            *jd.crop_tables(plain_rgb[data].shape[1],
                            plain_rgb[data].shape[0], *dr, size)).numpy()
            for data, dr in zip(jpegs, draws)]).astype(np.int16)
        stage_diff = np.abs(card - plain)
        stage_row = {"max_abs": int(stage_diff.max()),
                     "mean_abs": float(stage_diff.mean()),
                     "worst_image_mean": float(stage_diff.reshape(
                         len(jpegs), -1).mean(1).max())}
        # tr_resize_crop alone against its plain version, same pixels.
        src, offsets, sizes = stage.decoder.decode_batch(jpegs)
        tables = jd.crop_table_batch([s[:2] for s in sizes], draws, size)
        tabs = [torch.from_numpy(a).cuda() for a in (
            offsets, np.array(sizes, np.int32), *tables)]
        views = [src[o:o + w * h * c].view(h, w, c)
                 for o, (w, h, c) in zip(offsets.tolist(), sizes)]

        def plain_resize():
            return torch.stack([jd.resize_crop_reference(
                v, tables[0][j], tables[1][j], tables[2][j])
                for j, v in enumerate(views)])

        before = jd.launches
        kernel = jd.resize_crop(src, *tabs)
        resize_launches = jd.launches - before
        resize_err = int((kernel.int() - plain_resize().int()).abs().max())
        ms = time_ms(lambda: jd.resize_crop(src, *tabs), queued=True)
        call_ms = time_ms(lambda: jd.resize_crop(src, *tabs), queued=False)
        # ~0.25 s an image on the host: one call, warmed by the check above.
        plain_ms = time_ms(plain_resize, queued=False, reps=1, inner=1,
                           warmup=0)
        bound_ms, bound_by = resize_bound(sizes, tables, size)

        # The parts' times: nvJPEG's decodes, the whole stage per batch.
        def wall(fn, reps=5):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / reps

        nvjpeg_ms = wall(lambda: stage.decoder.decode_batch(jpegs))
        # nvJPEG's bytes: the JPEGs read once, the decoded pixels written
        # once (its Huffman decode runs on the host, which this leaves out).
        nvjpeg_bytes = sum(map(len, jpegs)) + sum(w * h * c
                                                  for w, h, c in sizes)
        stage_ms = wall(lambda: stage.batch(records, draws))
    finally:
        stage.close()
    return {"batch": len(jpegs), "distinct_jpegs": len(plain_rgb),
            "jpeg_bytes_mean": sum(map(len, jpegs)) / len(jpegs),
            "nvjpeg_vs_plain": nvjpeg, "stage_vs_plain": stage_row,
            "resize_crop": {
                "name": "resize_crop", "route": "cuda",
                "source": "tpu_resnet_torch/csrc/jpeg_decode.cu",
                "replaces": "tpu_resnet/native/loader.cc:266 "
                            "(resize_bilinear_window, host C++; no TPU "
                            "kernel)",
                "max_abs_err": resize_err, "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "launches_per_batch": resize_launches},
            "nvjpeg_ms_per_batch": nvjpeg_ms,
            "nvjpeg_bytes_bound_ms": 1e3 * nvjpeg_bytes / HBM_BYTES_PER_S,
            # The plain decoder on the host, one thread, per image and as
            # a B=128 batch would take it.
            "plain_decode_ms_per_image": plain_decode_ms,
            "plain_decode_ms_per_batch": plain_decode_ms * len(jpegs),
            "stage_ms_per_batch": stage_ms,
            "stage_images_per_s": 1e3 * len(jpegs) / stage_ms}


def decode_stage_checks(root: str, cfg, gpu: str) -> dict:
    """:func:`decode_stage_measure` held to ``NVJPEG_TOL``, ``STAGE_TOL``
    and ``RESIZE_TOL``, one ``tr_resize_crop`` launch a batch."""
    out = decode_stage_measure(root, cfg)
    for s, row in out["nvjpeg_vs_plain"].items():
        row["limit"] = NVJPEG_TOL[s]
        check(row["max_abs"] <= NVJPEG_TOL[s][0]
              and row["mean_abs"] <= NVJPEG_TOL[s][1],
              f"nvJPEG against the plain decoder at {s}: {row}")
    row = out["stage_vs_plain"]
    row["limit"] = STAGE_TOL
    check(row["max_abs"] <= STAGE_TOL[0] and row["mean_abs"] <= STAGE_TOL[1],
          f"decode stage against the plain versions: {row}")
    resize = out["resize_crop"]
    check(resize["launches_per_batch"] == 1, "resize_crop: not one launch")
    check(resize["max_abs_err"] <= RESIZE_TOL, f"tr_resize_crop against its "
          f"plain version: max |d| {resize['max_abs_err']} > {RESIZE_TOL}")
    out["gpu"] = gpu
    return out


def imagenet_input_phase(counters, gpu: str, seeded: dict) -> dict:
    """ImageNet ResNet-50 training and eval from JPEG shards through the
    port's input pipeline: the decode stage's checks and times, then
    ``train()`` for INPUT_STEPS steps with the launches read around it, a
    batch read after its step against a synchronous decode of its order, a
    resume from INPUT_RESUME_AT bit for bit, ``evaluate`` once over exactly
    INPUT_VALIDATION records, and the step fed by the engine profiled
    beside the seeded-batch phase's (``seeded``)."""
    from tpu_resnet_torch import data as data_lib
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.data import engine
    from tpu_resnet_torch.data.imagenet import ImageNetIterator
    from tpu_resnet_torch.evaluation.evaluator import evaluate
    from tpu_resnet_torch.ops import jpeg_decode as jd
    from tpu_resnet_torch.tools.profiling import profile_train_step
    from tpu_resnet_torch.train.loop import make_loop_step, train

    path = "imagenet_fused_train"
    root = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    dir_a = tempfile.mkdtemp(prefix="chip_smoke_jpeg_a_")
    dir_b = tempfile.mkdtemp(prefix="chip_smoke_jpeg_b_")
    records = LogRecords()
    logger = logging.getLogger("tpu_resnet_torch")
    logger.addHandler(records)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        t0 = time.monotonic()
        payloads = make_input_shards(root)
        shard_seconds = time.monotonic() - t0

        def config(train_dir, steps):
            return load_config("imagenet", "", [
                *INPUT_OVERRIDES, f"data.data_dir={root}",
                f"train.train_dir={train_dir}", f"train.train_steps={steps}",
                "train.log_every=1",
                f"train.checkpoint_every={INPUT_RESUME_AT}"])

        cfg = config(dir_a, INPUT_STEPS)
        check(cfg.data.resolved_image_size == 224
              and cfg.train.global_batch_size == TRAIN_BATCH
              and cfg.train.eval_batch_size * 2 == INPUT_VALIDATION,
              "imagenet preset: 224x224, B=128, eval batch 125")
        stage = decode_stage_checks(root, cfg, gpu)

        # train() from the shards, every batch tapped.
        per_step = PER_PASS[path]
        run_a = {}
        zero_counts(counters)
        jd.launches = 0
        t0 = time.monotonic()
        with tapped_stream(set(range(INPUT_STEPS)), run_a):
            state = train(cfg, device="cuda")
        torch.cuda.synchronize()
        train_seconds = time.monotonic() - t0
        counts, resizes = read_counts(counters), jd.launches
        check(state.step == INPUT_STEPS, f"train() stopped at {state.step}")
        want = {k: n * INPUT_STEPS for k, n in per_step.items()}
        check(counts == want, f"{path} from JPEG shards: launch counts "
              f"{counts} over {INPUT_STEPS} steps, expected {want}")
        ring = 2 * cfg.data.num_workers + 1
        check(INPUT_STEPS <= resizes <= INPUT_STEPS + ring,
              f"tr_resize_crop launched {resizes} times for {INPUT_STEPS} "
              f"steps and a ring of {ring}")
        with open(os.path.join(dir_a, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs]
        check([r["step"] for r in recs] == list(range(1, INPUT_STEPS + 1))
              and all(np.isfinite(losses)), f"losses {losses}")
        check(recs[-1]["data_stream_seq"] == INPUT_STEPS,
              f"stream at seq {recs[-1]['data_stream_seq']}")

        # Each batch, read after its step, against a synchronous decode of
        # its order (a batch the step read before it was written, or whose
        # decode raced, differs).
        it = ImageNetIterator.from_config(cfg.data, TRAIN_BATCH,
                                          seed=cfg.train.seed)
        sync_stage = engine.DecodeStage(torch.device("cuda"),
                                        cfg.data.resolved_image_size,
                                        TRAIN_BATCH)
        differ = []
        try:
            for seq, order in enumerate(itertools.islice(it.work_orders(),
                                                         INPUT_STEPS)):
                images, labels, _ = sync_stage.batch(
                    engine.read_order(order, it.files),
                    engine.order_draws(draw_params(cfg), seq, len(order)))
                torch.cuda.synchronize()
                got = run_a[seq]
                bad = [j for j in range(TRAIN_BATCH)
                       if not torch.equal(got[0][j], images[j].cpu())]
                if bad or not torch.equal(got[1], labels.cpu()):
                    differ.append((seq, bad[:8]))
        finally:
            sync_stage.close()
        check(not differ, f"batches read after their steps differ from a "
              f"synchronous decode of their orders: (seq, images) {differ}")
        tapped = run_a[INPUT_RESUME_AT]

        # Resume at INPUT_RESUME_AT from run A's checkpoint.
        shutil.copytree(os.path.join(dir_a, str(INPUT_RESUME_AT)),
                        os.path.join(dir_b, str(INPUT_RESUME_AT)))
        run_b = {}
        zero_counts(counters)
        jd.launches = 0
        with tapped_stream({INPUT_RESUME_AT, INPUT_RESUME_AT + 1}, run_b):
            resumed = train(config(dir_b, INPUT_RESUME_AT + 2),
                            device="cuda")
        torch.cuda.synchronize()
        resume_counts, resume_resizes = read_counts(counters), jd.launches
        check(resumed.step == INPUT_RESUME_AT + 2,
              f"resumed run stopped at {resumed.step}")
        check(resume_counts == {k: 2 * n for k, n in per_step.items()},
              f"resumed run launch counts {resume_counts}")
        for seq in (INPUT_RESUME_AT, INPUT_RESUME_AT + 1):
            check(torch.equal(run_b[seq][0], run_a[seq][0])
                  and torch.equal(run_b[seq][1], run_a[seq][1]),
                  f"the resumed stream's batch {seq} differs from the "
                  "uninterrupted run's")
        with open(os.path.join(dir_b, "metrics.jsonl")) as f:
            resumed_losses = [json.loads(line)["loss"] for line in f]
        del resumed

        # eval --once over the validation shard.
        cfg.train.eval_once = True
        zero_counts(counters)
        jd.launches = 0
        records.messages.clear()
        precision = evaluate(cfg, device="cuda")
        eval_counts, eval_resizes = read_counts(counters), jd.launches
        evals = [m for m in records.messages if m.startswith("eval @ step")]
        forwards = INPUT_VALIDATION // cfg.train.eval_batch_size
        want = {k: PER_PASS["imagenet"][k] * forwards for k in KERNELS}
        check(eval_counts == want, f"eval launch counts {eval_counts}, "
              f"expected {want}")
        check(eval_resizes == forwards, f"eval tr_resize_crop launches "
              f"{eval_resizes}")
        check(len(evals) == 1 and evals[0].endswith(
            f"{INPUT_VALIDATION} examples)") and precision is not None,
              f"eval: {evals}")

        # The step fed by the engine, profiled in its steady state: a
        # fresh engine fills its ring (the prefetch) ahead of the step, so
        # the window starts only when the step has drained it (a batch not
        # yet decoded when the step asks for it) or the step stays behind
        # the decode for INPUT_SETTLE_MAX steps (the ring full at both
        # ends); the ring's batches at the window's start and end show
        # which.
        feed = data_lib.train_batches(cfg.data, TRAIN_BATCH,
                                      seed=cfg.train.seed,
                                      start_step=state.step, device="cuda")
        step_fn = make_loop_step(cfg, torch.device("cuda"))
        try:
            settle = 0
            while settle < INPUT_SETTLE_MAX and (
                    settle < 3 or feed.stats()["data_ring_occupancy"] > 0):
                step_fn(state, *next(feed))
                settle += 1
            prof = profile_train_step(state, step_fn, feed,
                                      iters=INPUT_PROFILE_STEPS, warmup=0,
                                      probe=feed.stats)
        finally:
            feed.close()
    finally:
        logger.removeHandler(records)
        logger.setLevel(level)
        for tmp in (root, dir_a, dir_b):
            shutil.rmtree(tmp, ignore_errors=True)
    window_s = recs[-1]["wall"] - recs[0]["wall"]
    rates = [r["data_decode_images_per_sec"] for r in recs[1:]]
    seeded_prof = seeded["profile"]
    entry = dict(stage.pop("resize_crop"),
                 launches=resizes + resume_resizes + eval_resizes)
    result = {
        "path": "imagenet_jpeg_train",
        "model": f"imagenet ResNet-50 224x224 fused_blocks=on "
                 f"fused_epilogue=on use_pallas_xent=on "
                 f"{cfg.model.compute_dtype}, B={TRAIN_BATCH}, from JPEG "
                 f"shards ({len(payloads)} fixture JPEGs cycled)",
        "shards": {"train": INPUT_TRAIN_SHARDS * INPUT_PER_SHARD,
                   "validation": INPUT_VALIDATION, "seconds": shard_seconds},
        "decode_workers": cfg.data.num_workers, "decode_stage": stage,
        "steps": INPUT_STEPS, "train_seconds": train_seconds,
        "launches": {k: counts[k] + resume_counts[k] for k in KERNELS},
        "launches_per_step": per_step, "eval_launches": eval_counts,
        "resize_launches": {"train": resizes, "resume": resume_resizes,
                            "eval": eval_resizes},
        "losses": losses, "resumed_losses": resumed_losses,
        "resume_batches_equal": [INPUT_RESUME_AT, INPUT_RESUME_AT + 1],
        "read_after_step_equal_batches": INPUT_STEPS,
        "loop_window_steps": INPUT_STEPS - 1, "loop_window_s": window_s,
        "loop_ms_per_step": 1e3 * window_s / (INPUT_STEPS - 1),
        "loop_images_per_s": TRAIN_BATCH * (INPUT_STEPS - 1) / window_s,
        "engine_decode_images_per_s_median": statistics.median(rates),
        # The host clock's window: the engine's ring at its start and end
        # (decoded batches not yet taken) and its decode rate over it.
        "profile_settle_steps": settle,
        "profile_ring_batches": [p["data_ring_occupancy"]
                                 for p in prof["probe"]],
        "profile_ring_slots": prof["probe"][1]["data_ring_slots"],
        "engine_decode_images_per_s_profiled":
            prof["probe"][1]["data_decode_images_per_sec"],
        "eval_records": INPUT_VALIDATION, "eval_precision": precision,
        "profile": {k: v for k, v in prof.items() if k != "kernels"},
        "profile_top_kernels": prof["kernels"][:12],
        "seeded_profile": {k: seeded_prof.get(k) for k in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "step_busy_ms_per_step",
            "step_idle_share", "images_per_s")},
        "resize_crop": entry, "gpu": gpu}
    emit("imagenet_input", **result)
    return result


def probe_shapes() -> dict:
    """{path: BN+ReLU shapes} of the cifar10 and imagenet presets' models
    at B=TRAIN_BATCH, as ``ep.model_epilogue_shapes`` gives them: where the
    reference's autotune probes (and so reaches ``_sbr_add_kernel``)."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.ops import epilogue as ep
    return {f"{preset}_probe": ep.model_epilogue_shapes(
        load_config(preset), TRAIN_BATCH) for preset in ("cifar10",
                                                         "imagenet")}


def sbr_add_kernel_phase(ep):
    """``sbr_add`` against its plain version at every probe shape, bfloat16
    and float32: the forward bit for bit; through autograd, dx bit for bit,
    dr == g and ds/db within ``SBR_BWD_TOL`` of the plain backward. Times
    are the forward's (the kernel's) against the plain forward's."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for path, shapes in probe_shapes().items():
        for shape in shapes:
            c = shape[-1]
            for dtype in (torch.bfloat16, torch.float32):
                def randn():
                    return torch.randn(shape, generator=gen,
                                       device="cuda").to(dtype)
                x, r, g = randn(), randn(), randn()
                sc = torch.rand(c, generator=gen, device="cuda") + 0.5
                bi = torch.randn(c, generator=gen, device="cuda") * 0.5
                name = f"sbr_add {shape} {dtype}"
                got = ep.scale_bias_relu_add(x, sc, bi, r)
                want = ep.scale_bias_relu_add_reference(x, sc, bi, r)
                torch.cuda.synchronize()
                check(got.dtype == dtype and torch.equal(got, want),
                      f"{name}: forward differs from the plain version")
                err = float((got.float() - want.float()).abs().max())
                del got, want
                grads = []
                for fn in (ep.scale_bias_relu_add,
                           ep.scale_bias_relu_add_reference):
                    leaves = [t.clone().requires_grad_(True)
                              for t in (x, sc, bi, r)]
                    fn(*leaves).backward(g)
                    grads.append([t.grad for t in leaves])
                    del leaves
                (dx, ds, db, dr), (wdx, wds, wdb, wdr) = grads
                check(torch.equal(dx, wdx), f"{name}: dx differs")
                check(torch.equal(dr, g) and torch.equal(wdr, g),
                      f"{name}: dr is not g")
                gm = torch.where(x.float() * sc + bi > 0, g.float(), 0.0)
                rtol, atol = SBR_BWD_TOL
                excess = 0.0
                for got_s, ref, terms in ((ds, wds, gm * x.float()),
                                          (db, wdb, gm)):
                    limit = rtol * terms.abs().sum(dim=(0, 1, 2)) + atol
                    excess = max(excess, float(((got_s - ref).abs()
                                                / limit).max()))
                del grads, dx, wdx, dr, wdr, gm
                row = {"kernel": "sbr_add", "path": path,
                       "shape": list(shape),
                       "dtype": str(dtype).split(".")[1], "per_pass": 1,
                       "max_abs_err": err, "ds_db_err_over_limit": excess,
                       "tolerance": "forward, dx exact; dr == g; ds, db "
                                    "<= 1e-5*sum|terms| + 1e-6"}
                check(excess <= 1, f"{name}: ds/db beyond tolerance: {row}")
                with torch.no_grad():
                    rows.append(_timed(
                        row, lambda: ep.scale_bias_relu_add(x, sc, bi, r),
                        lambda: ep.scale_bias_relu_add_reference(
                            x, sc, bi, r), "sbr_add", shape, dtype))
                del x, r, g
    torch.cuda.empty_cache()
    return rows


class LogRecords(logging.Handler):
    """Keeps the messages logged through it."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def autotune_phase(counters, gpu: str) -> dict:
    """The autotune harness on the card: (a) ``probe_epilogue`` with the
    residual-add variant at every probe shape, its launches counted; (b)
    the slice's ``auto`` train path through ``train()`` and ``evaluate``,
    each launch count checked against the decisions it made."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.evaluation.evaluator import evaluate
    from tpu_resnet_torch.ops import autotune
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import softmax_xent as sx
    from tpu_resnet_torch.train.loop import train

    # (a) the probe: the only route to _sbr_add_kernel in the reference.
    autotune.reset()
    shapes = [s for ss in probe_shapes().values() for s in ss]
    zero_counts(counters)
    t0 = time.monotonic()
    decisions = []
    for shape in shapes:
        decisions += ep.probe_epilogue(shape, torch.bfloat16,
                                       iters=PROBE_ITERS, force=True,
                                       include_add=True, device="cuda")
    torch.cuda.synchronize()
    probe_seconds = time.monotonic() - t0
    probe_counts = read_counts(counters)
    calls = len(shapes) * (PROBE_ITERS + 1)
    want = {k: 0 for k in KERNELS}
    want.update(sbr=calls, sbr_add=calls, sbr_bwd=2 * calls)
    check(probe_counts == want, f"probe launch counts {probe_counts}, "
          f"expected {want}")
    for d in decisions:
        check(np.isfinite(d.pallas_us) and np.isfinite(d.xla_us)
              and d.pallas_us > 0 and d.xla_us > 0
              and d.use_pallas == (d.speedup >= 1.0) and d.error is None,
              f"inconsistent decision {d}")
    probed = [d.to_dict() for d in decisions]
    torch.cuda.empty_cache()

    # (b) the slice's train path on the preset's defaults.
    autotune.reset()
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_auto_")
    records = LogRecords()
    logger = logging.getLogger("tpu_resnet_torch")
    logger.addHandler(records)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        cfg = load_config("cifar10", "", [
            *AUTO_OVERRIDES, f"train.train_dir={train_dir}",
            f"train.train_steps={AUTO_STEPS}", "train.log_every=1",
            f"train.checkpoint_every={AUTO_STEPS}"])
        check(cfg.optim.use_pallas_xent == "auto"
              and cfg.data.device_resident == "auto"
              and cfg.train.global_batch_size == TRAIN_BATCH,
              "the cifar10 preset's defaults are not auto, B=128")
        zero_counts(counters)
        t0 = time.monotonic()
        state = train(cfg, device="cuda")
        torch.cuda.synchronize()
        train_seconds = time.monotonic() - t0
        counts = read_counts(counters)
        check(state.step == AUTO_STEPS, f"train() stopped at {state.step}")
        check(any("input device-resident" in m for m in records.messages),
              "the train log does not name the device-resident input")
        with open(os.path.join(train_dir, autotune.AUTOTUNE_FILE)) as f:
            table = json.load(f)["decisions"]
        want_keys = {f"{ep.OP_SBR}|{ep.sbr_key(s)}"
                     for s, _ in TRAIN_SBR} | {f"{sx.OP_XENT}|{TRAIN_BATCH}x10"}
        check(set(table) == want_keys, f"autotune.json lists {sorted(table)}"
              f", expected {sorted(want_keys)}")
        kernel_sites = sum(n for s, n in TRAIN_SBR
                           if table[f"{ep.OP_SBR}|{ep.sbr_key(s)}"]
                           ["use_pallas"])
        xent = int(table[f"{sx.OP_XENT}|{TRAIN_BATCH}x10"]["use_pallas"])
        per_step = {k: 0 for k in KERNELS}
        per_step.update(sbr=kernel_sites, sbr_bwd=kernel_sites,
                        xent_fwd=xent, xent_bwd=xent)
        want = {k: n * AUTO_STEPS for k, n in per_step.items()}
        check(counts == want, f"auto train launch counts {counts}, "
              f"expected {want}")
        with open(os.path.join(train_dir, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        check(len(losses) == AUTO_STEPS and all(np.isfinite(losses)),
              f"losses {losses}")
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(
            losses[-5:]))
        check(last5 < first5, f"loss did not fall: first 5 mean {first5}, "
              f"last 5 {last5}")
        cfg.train.eval_once = True
        zero_counts(counters)
        precision = evaluate(cfg, device="cuda")
        eval_counts = read_counts(counters)
        with open(os.path.join(train_dir, "eval", "metrics.jsonl")) as f:
            eval_rec = json.loads(f.readlines()[-1])
        check(precision is not None and np.isfinite(eval_rec["eval_loss"])
              and eval_rec["step"] == AUTO_STEPS, f"eval {eval_rec}")
    finally:
        logger.removeHandler(records)
        logger.setLevel(level)
        shutil.rmtree(train_dir, ignore_errors=True)
        autotune.reset()
    result = {
        "path": "cifar10_auto_train",
        "model": "cifar10 ResNet-50 32x32 fused_epilogue=auto "
                 "use_pallas_xent=auto device_resident=auto bf16, B=128",
        "probe_shapes": [list(s) for s in shapes],
        "probe_iters": PROBE_ITERS, "probe_seconds": probe_seconds,
        "probe_launches": probe_counts, "probe_decisions": probed,
        "train_decisions": table, "steps": AUTO_STEPS,
        "train_seconds": train_seconds,
        "launches": {k: probe_counts[k] + counts[k] for k in KERNELS},
        "train_launches": counts, "launches_per_step": per_step,
        "loss_first5_mean": first5, "loss_last5_mean": last5,
        "eval_precision": precision, "eval_loss": eval_rec["eval_loss"],
        "eval_launches": eval_counts, "gpu": gpu}
    emit("autotune", **result)
    return result


def ab_phase(counters, gpu: str) -> list:
    """The twins of the reference's A/B tools on the card, through their
    per-shape functions, at the reference's shapes in bfloat16: per shape,
    one ``fwd_bwd`` call of ``AB_LENGTH`` chained blocks with the counters
    zeroed just before and read just after (``AB_LENGTH`` launches of the
    block's forward and gradient kernels and nothing else, every gradient
    finite), then the four arms' times (``run_shape``, ``AB_REPS`` timed
    calls per arm), listing under ``host_paced`` each arm whose device spin
    did not hold (its time took in the host's gaps). One result per
    tool."""
    from tpu_resnet_torch.tools import fused_block_ab, fused_bottleneck_ab

    cuda = torch.device("cuda")

    def block(shape):   # two weight gradients a block_bwd at C >= 128
        return {"block_fwd": 1, "block_bwd": 1,
                "bottleneck_wgrad": 2 if shape[-1] in WIDE_CHANNELS else 0}

    # Each tool: launches of each kernel per chained block, by shape.
    tools = (("cifar10_ab", fused_block_ab, fused_block_ab.SHAPES, block),
             ("imagenet_ab", fused_bottleneck_ab,
              [(b, h, h, 4 * f) for b, h, f in fused_bottleneck_ab.SHAPES],
              lambda shape: {"bottleneck_fwd": 1, "bottleneck_bwd": 1,
                             "bottleneck_wgrad": 3}),
             ("imagenet34_ab", fused_block_ab,
              fused_block_ab.IMAGENET_SHAPES, block))
    results = []
    for path, tool, shapes, kinds in tools:
        total = {k: 0 for k in KERNELS}
        by_shape, host_paced = {}, []
        t0 = time.monotonic()
        for shape in shapes:
            per_call = {k: AB_LENGTH * kinds(shape).get(k, 0)
                        for k in KERNELS}
            x0, arms = tool.make_arms(shape, AB_LENGTH, torch.bfloat16, cuda)
            zero_counts(counters)
            grads = arms["fwd_bwd"][0](x0)
            torch.cuda.synchronize()
            counts = read_counts(counters)
            check(counts == per_call, f"{path} {shape}: fwd_bwd launches "
                  f"{counts}, expected {per_call}")
            check(all(bool(torch.isfinite(g).all()) for g in grads),
                  f"{path} {shape}: a gradient is not finite")
            total = {k: total[k] + counts[k] for k in KERNELS}
            del x0, arms, grads
            key = tool.shape_key(shape)
            by_shape[key] = tool.run_shape(shape, AB_LENGTH, AB_REPS,
                                           torch.bfloat16, cuda)
            host_paced += [f"{key} {arm} {side}"
                           for arm, e in by_shape[key].items()
                           for side, flag in (("kernel", "pallas"),
                                              ("plain", "xla"))
                           if e[f"{flag}_host_paced"]]
            torch.cuda.empty_cache()
        result = {
            "path": path, "tool": tool.__name__, "length": AB_LENGTH,
            "reps": AB_REPS, "dtype": "bfloat16",
            "shapes": [list(s) for s in shapes], "seconds":
            time.monotonic() - t0, "launches": total,
            "eval_launches": {k: 0 for k in KERNELS},
            # Per fwd_bwd call, the mean over the shapes.
            "launches_per_step": {k: n / len(shapes)
                                  for k, n in total.items()},
            "by_shape": by_shape,
            "host_paced": host_paced, "gpu": gpu}
        emit("ab", **result)
        results.append(result)
    return results


def _spread_bn(model, gen) -> None:
    """BN parameters and running statistics off their init (scales and
    variances in [0.5, 1.5), biases and means of std 0.2), so that every
    fold is its own affine."""
    from tpu_resnet_torch.models.resnet import BatchNormRelu
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormRelu):
                for t, kind in ((m.weight, 1), (m.running_var, 1),
                                (m.bias, 0), (m.running_mean, 0)):
                    t.copy_(torch.rand(t.shape, generator=gen) + 0.5 if kind
                            else torch.randn(t.shape, generator=gen) * 0.2)


def _grad_rel(got, want) -> list:
    """Each tensor's normwise distance ||got - want|| / ||want||."""
    return [float((g - w).norm() / w.norm().clamp_min(1e-30))
            for g, w in zip(got, want)]


def grad_phase(preset: str, counters, gpu: str) -> dict:
    """The gradient of an eval-mode fused model (``GRAD_OVERRIDES`` on
    ``preset``, seeded weights, BN off its init, float32, B=GRAD_BATCH) in
    the input images and every parameter, of Σ logits·cotangent: through
    the kernels with the counters zeroed just before the forward and read
    just after the backward (``GRAD_PER_BACKWARD``), through the plain
    versions, and through the control (the plain versions on PyTorch's own
    convolutions). Gated normwise per tensor, as the port's tests gate
    gradients: the worst ||got - plain|| / ||plain|| within ``GRAD_RTOL``'s
    floor or ``CONTROL_FACTOR`` times the control's worst (the fused blocks
    sum in another order, and a recomputed mask [a > 0] flips where a lies
    within rounding of 0), and never beyond its ceiling, so that a zeroed
    (1.0) or sign-flipped (2.0) tensor fails whatever the control reads."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.models import build_model, init_weights

    cfg = load_config(preset, "", GRAD_OVERRIDES)
    size, classes = cfg.data.resolved_image_size, cfg.data.num_classes
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(6))
    _spread_bn(model, torch.Generator().manual_seed(7))
    model = model.to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(GRAD_BATCH, size, size, 3, generator=gen, device="cuda")
    cot = torch.randn(GRAD_BATCH, classes, generator=gen, device="cuda")
    names = ["input"] + [n for n, _ in model.named_parameters()]
    params = list(model.parameters())

    def grads():
        leaf = x.clone().requires_grad_()
        logits = model(leaf, train=False)
        return torch.autograd.grad((logits.float() * cot).sum(),
                                   [leaf, *params])

    zero_counts(counters)
    got = grads()
    torch.cuda.synchronize()
    counts = read_counts(counters)
    want = {k: GRAD_PER_BACKWARD[preset].get(k, 0) for k in KERNELS}
    check(counts == want, f"{preset} grad: launch counts {counts}, expected "
          f"{want}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{preset} grad: a gradient is not finite")
    zero_counts(counters)
    with plain_versions():
        plain = grads()
    with plain_native_convs():
        control = grads()
    torch.cuda.synchronize()
    check(not any(read_counts(counters).values()),
          f"{preset} grad: the plain arms launched kernels")
    rel, control_rel = _grad_rel(got, plain), _grad_rel(control, plain)
    worst, control_worst = max(rel), max(control_rel)
    floor, ceiling = GRAD_RTOL
    limit = min(max(CONTROL_FACTOR * control_worst, floor), ceiling)
    result = {
        "path": f"{preset}_grad",
        "model": f"{preset} ResNet-50 {size}x{size} fused_blocks=on "
                 f"fused_epilogue=on float32 eval mode, B={GRAD_BATCH}",
        "tensors_compared": len(got), "launches": counts,
        "eval_launches": {k: 0 for k in KERNELS}, "launches_per_step": want,
        "worst_rel": worst, "control_worst_rel": control_worst,
        "limit": limit, "tensors_over_floor": sum(r > floor for r in rel),
        "worst_tensors": sorted(zip(rel, names), reverse=True)[:5],
        "control_worst_tensors":
            sorted(zip(control_rel, names), reverse=True)[:3],
        "control_factor": CONTROL_FACTOR, "grad_rtol": GRAD_RTOL,
        "gpu": gpu}
    check(worst <= limit, f"{preset} grad: a tensor beyond {limit} "
          f"normwise: {result}")
    emit("grad", **result)
    del model, got, plain, control
    torch.cuda.empty_cache()
    return result


# The cli phase: the port's run tools through ``python -m
# tpu_resnet_torch``; the graphed fused CIFAR train that the profiler
# window and trace-export read (30 steps, chunks of 10, the window steps
# 10..20 and, in a second run, 0..10: the warm-up and the capture).
CLI_TIMEOUT = 300
CLI_STEPS, CLI_PER_CALL = 30, 10
CLI_WINDOWS = ("10:20", "0:10")
CLI_OVERRIDES = [*TRAIN_OVERRIDES, "model.fused_blocks=true",
                 f"train.steps_per_call={CLI_PER_CALL}",
                 f"train.train_steps={CLI_STEPS}", "train.log_every=10",
                 "train.checkpoint_every=10"]
CLI_PARAMS = "trainable params: 25,549,352"


def run_cli(*args, timeout: int = CLI_TIMEOUT) -> tuple:
    """(exit code, standard output) of ``python -m tpu_resnet_torch
    *args`` run from the repository root."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_resnet_torch", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr[-2000:]


def doctor_check() -> dict:
    """``doctor --probe-timeout 60`` on the card: every check ok, an H100
    of capability 9.0, nvcc found, every kernel library built, the empty
    launch made."""
    from tpu_resnet_torch.ops import _build
    rc, out = run_cli("doctor", "--probe-timeout", "60")
    line = next((ln for ln in out.splitlines()
                 if ln.startswith("DOCTOR_JSON: ")), None)
    check(line is not None, f"doctor printed no DOCTOR_JSON line:\n{out}")
    summary = json.loads(line[len("DOCTOR_JSON: "):])
    check(rc == 0 and summary["ok"], f"doctor failed (rc {rc}):\n{out}")
    backend, kernels = summary["backend"], summary["kernels"]
    check("H100" in backend["device_kind"]
          and backend["capability"] == "9.0",
          f"doctor's backend: {backend}")
    check(kernels["nvcc"] and kernels["built"] == sorted(_build.SIGNATURES)
          and kernels["noop"] == "launched", f"doctor's kernels: {kernels}")
    return {"rc": rc, "backend": backend, "kernels": kernels,
            "versions": summary["versions"]}


def cli_train(train_dir: str, counters, window: str = "") -> dict:
    """The graphed fused CIFAR ``train()`` of the cli phase (``window``:
    its ``train.profile_steps``): its launches, metrics and end state."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.train.loop import train
    cfg = load_config("cifar10", "", [
        *CLI_OVERRIDES, f"train.train_dir={train_dir}",
        f"train.profile_steps={window}"])
    gc_collect()
    zero_counts(counters)
    state = train(cfg, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts(counters)
    check(state.step == CLI_STEPS, f"cli train stopped at {state.step}")
    want = {k: n * CLI_STEPS
            for k, n in PER_PASS["cifar10_fused_train"].items()}
    check(counts == want, f"cli train ({window or 'unprofiled'}): launch "
          f"counts {counts}, expected {want}")
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        losses = [(r["step"], r["loss"]) for r in map(json.loads, f)]
    from tpu_resnet_torch.train import checkpoint
    tensors = {n: t.detach().clone()
               for n, t in state_tensors(state, []).items()}
    for step in checkpoint.all_steps_in(train_dir):
        saved = checkpoint.restore(train_dir, step)
        for part in ("params", "batch_stats", "opt_state"):
            tensors.update({f"checkpoint {step} {part}/{n}": t
                            for n, t in saved[part].items()})
    return {"counts": counts, "losses": losses, "tensors": tensors}


def device_window(trace: dict) -> dict:
    """The merged device lanes of an exported trace against its
    ``profiler_trace`` span: events outside the span, busy time (union
    over every lane), the lanes' extent and idle share, each lane's busy
    time, and the longest gaps between busy intervals."""
    from tpu_resnet_torch.tools.profiling import union_ms
    events = trace["traceEvents"]
    (span,) = [e for e in events if e["name"] == "profiler_trace"]
    lo, hi = span["ts"], span["ts"] + span["dur"]
    dev = [e for e in events if e.get("cat") == "device"]
    lanes = {}
    for e in events:
        if e["ph"] == "M" and e["name"] == "thread_name" and \
                e["pid"] >= 9000000:
            lanes[(e["pid"], e["tid"])] = e["args"]["name"]
    outside = [e["name"] for e in dev
               if e["ts"] < lo or e["ts"] + e["dur"] > hi + 0.1]
    ivs = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in dev)
    extent_ms = (ivs[-1][1] - ivs[0][0]) / 1e3 if ivs else 0.0
    busy_ms = union_ms((a, b) for a, b, _ in ivs)
    # Idle gaps between busy intervals: (ms, the event that ended last
    # before it, the event after it).
    gaps, end, last = [], None, None
    for a, b, name in ivs:
        if end is not None and a > end:
            gaps.append(((a - end) / 1e3, last[:60], name[:60]))
        if end is None or b >= end:
            end, last = b, name
    bins = {"under_2us": (0, 0.002), "2_to_10us": (0.002, 0.01),
            "10_to_100us": (0.01, 0.1), "over_100us": (0.1, 1e9)}
    gap_bins = {k: {"gaps": sum(1 for g, _, _ in gaps if lo_ <= g < hi_),
                    "ms": sum(g for g, _, _ in gaps if lo_ <= g < hi_)}
                for k, (lo_, hi_) in bins.items()}
    by_name = {}
    for e in dev:
        row = by_name.setdefault(e["name"][:60], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] / 1e3
    by_lane = {}
    for (pid, tid), name in sorted(lanes.items()):
        mine = [(e["ts"], e["ts"] + e["dur"]) for e in dev
                if e["pid"] == pid and e["tid"] == tid]
        by_lane[name] = {"events": len(mine), "busy_ms": union_ms(mine)}
    return {"span_ms": span["dur"] / 1e3, "device_events": len(dev),
            "outside_span": outside[:10], "n_outside_span": len(outside),
            "extent_ms": extent_ms, "busy_ms": busy_ms,
            "idle_ms": extent_ms - busy_ms,
            "idle_share": 1 - busy_ms / extent_ms if extent_ms else None,
            "gap_bins": gap_bins,
            "longest_gaps": sorted(gaps, reverse=True)[:8],
            "top_names": sorted(([n, c, ms] for n, (c, ms)
                                 in by_name.items()),
                                key=lambda r: -r[1])[:12],
            "by_lane": by_lane}


def export_window(train_dir: str, counts: dict) -> dict:
    """``trace-export --device-trace`` on a profiled run: every kernel the
    counters saw is named in the merged device lanes, every device event
    falls inside the ``profiler_trace`` span; the profiler's launches of
    each kernel over the window beside the counters' per-step count times
    the window's steps (the profiler drops launches now and then)."""
    from tpu_resnet_torch.tools.profiling import TRAIN_KERNELS
    rc, out = run_cli("trace-export", "--dir", train_dir, "--device-trace")
    check(rc == 0, f"trace-export failed (rc {rc}):\n{out}")
    with open(os.path.join(train_dir, "trace.json")) as f:
        trace = json.load(f)
    meta = trace["metadata"]["device_trace"]
    check(meta["anchored_by"] == "profiler_trace_span"
          and meta["device"] == "cuda", f"device trace: {meta}")
    window = device_window(trace)
    check(window["n_outside_span"] == 0, f"device events outside the "
          f"profiler_trace span: {window['outside_span']}")
    names = [e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "device"]
    (span,) = [e for e in trace["traceEvents"]
               if e["name"] == "profiler_trace"]
    steps = span["args"]["stop_step"] - span["args"]["start_step"]
    seen = {}
    for kernel, n in counts.items():
        if n:
            key = TRAIN_KERNELS[kernel]
            seen[kernel] = {
                "profiled": sum(1 for name in names if key in name),
                "counted": n // CLI_STEPS * steps
                * LAUNCHES_PER_CALL[kernel]}
    missing = [k for k, v in seen.items() if not v["profiled"]]
    check(not missing, f"kernels the counters saw and the device lanes do "
          f"not name: {missing}")
    return {"device_trace": meta, "window": window, "launches": seen}


def cli_phase(counters, gpu: str) -> dict:
    """The port's run tools on the card: ``doctor``, ``info``; a graphed
    fused CIFAR train profiled over steps 10..20, exported with its device
    lanes, and again over 0..10 (warm-up and capture in the window), both
    bit for bit an unprofiled run (losses, state); ``inspect`` and ``plot
    --csv`` on the first."""
    result = {"gpu": gpu, "doctor": doctor_check()}
    rc, out = run_cli("info", "--preset", "imagenet")
    check(rc == 0 and CLI_PARAMS in out, f"info (rc {rc}):\n{out}")
    result["info"] = CLI_PARAMS
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        plain = cli_train(os.path.join(root, "plain"), counters)
        for window in CLI_WINDOWS:
            train_dir = os.path.join(root, window.replace(":", "_"))
            run = cli_train(train_dir, counters, window)
            check(run["losses"] == plain["losses"],
                  f"profiled ({window}) losses differ: {run['losses']} vs "
                  f"{plain['losses']}")
            check(run["tensors"].keys() == plain["tensors"].keys(),
                  f"profiled ({window}) checkpoints differ")
            diff = [n for n, t in run["tensors"].items()
                    if not torch.equal(t, plain["tensors"][n])]
            check(not diff, f"profiled ({window}) state differs: {diff[:5]}")
            result[f"window_{window}"] = export_window(train_dir,
                                                       run["counts"])
        train_dir = os.path.join(root, CLI_WINDOWS[0].replace(":", "_"))
        rc, out = run_cli("inspect", "--dir", train_dir, "--peek",
                          "params/initial_conv.weight")
        check(rc == 0 and f"checkpoint step {CLI_STEPS}" in out,
              f"inspect (rc {rc}):\n{out}")
        # The CSV needs no matplotlib; the PNG does, and the card's
        # machine may lack it: then the command says so and exits 1.
        csv = os.path.join(root, "series.csv")
        rc, out = run_cli("plot", "--dir", train_dir, "--csv", csv)
        png = os.path.join(train_dir, "curves.png")
        no_mpl = rc == 1 and "No module named 'matplotlib'" in out
        check((rc == 0 and os.path.getsize(png) > 0) or no_mpl,
              f"plot (rc {rc}):\n{out}")
        with open(csv) as f:
            rows = f.read().splitlines()
        check(len(rows) == 1 + CLI_STEPS // 10, f"plot --csv rows: {rows}")
        result.update(inspect_rc=0, plot_rc=rc, plot_png=not no_mpl,
                      plot_csv_rows=len(rows) - 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("cli", **result)
    return result


# The data_parallel phase: the fused CIFAR path's overrides per rank
# (per-replica BN), the synced-BN path's (unfused, the cross-entropy
# kernels on), the steps each part times, and zero1's limits against
# replicated (the reference's test_zero1_replicated_step_parity_on_fakepod).
DP_FUSED = [*TRAIN_OVERRIDES, "model.fused_blocks=true",
            "model.sync_bn=false", "mesh.data=2"]
DP_SYNCED = ["optim.use_pallas_xent=on", "data.dataset=synthetic",
             "data.synthetic_learnable=true", "mesh.data=2"]
DP_RANKS, DP_TIMED_STEPS = 2, 10
ZERO1_TOL = (1e-6, 1e-6)
# The 2-rank train() runs of parts (b) and (c): run: (overrides, steps,
# log every); each checkpoints once, at its end. The synced zero1 run is
# held against 1-rank train() runs of its config (DP_ONE_RANK) over 2
# steps: these first steps carry a rounding difference across the whole
# state within a few steps (after 4, 2 ranks and the control alike lay
# 1.45 and 1.69 normwise from the 1-rank run on an H100), where no gate
# tells a fault from rounding.
DP_TRAIN_RUNS = {
    "b_fused_per_replica": (DP_FUSED, 20, 10),
    "c_zero1_synced": ([*DP_SYNCED, "model.compute_dtype=float32",
                        "mesh.partition=zero1"], 2, 1)}
DP_ONE_RANK = ["mesh.data=1"]


def nccl_world1_part(counters, gpu: str, alone: dict) -> dict:
    """(a) The fused CIFAR path through ``train()``, graphed, with an NCCL
    group of one rank open (the step's all-reduce captured in its graph,
    under NCCL's default asynchronous error handling), against ``alone``,
    the chunked_train phase's graphed run of that path without a group:
    bit for bit the same run, the same launches a step, and each run's
    loop ms a step."""
    from tpu_resnet_torch.parallel import multihost

    path = "cifar10_fused_train"
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_nccl1_")
    try:
        mesh = multihost.initialize(
            f"file://{rendezvous}/store", 1, 0, device_type="cuda")
        check(mesh is not None and mesh.size == 1
              and torch.distributed.get_backend() == "nccl",
              "no NCCL group of one rank")
        grouped = chunk_arm(path, counters, CHUNK_PER_CALL, None,
                            profiled=False)
    finally:
        multihost.shutdown()
        shutil.rmtree(rendezvous, ignore_errors=True)
    dist = run_distance(grouped["tensors"], alone["tensors"])
    check(dist["bit_equal"], f"(a) NCCL world 1 differs from no group: "
          f"{dist}")
    a, g = alone["arm"], grouped["arm"]
    check(g["launches"] == a["launches"], "(a) launches differ")
    return {"part": "a_nccl_world1", "path": path, "gpu": gpu,
            "nccl_async_error_handling": os.environ.get(
                "TORCH_NCCL_ASYNC_ERROR_HANDLING", "PyTorch's default"),
            "steps": g["steps"], "steps_per_call": CHUNK_PER_CALL,
            "bit_equal": dist["bit_equal"], "tensors": dist["tensors"],
            "launches_per_step": {k: n / g["steps"]
                                  for k, n in g["launches"].items() if n},
            "launches_per_step_no_group": {
                k: n / a["steps"] for k, n in a["launches"].items() if n},
            "loop_ms_per_step": g["loop_ms_per_step"],
            "loop_ms_per_step_no_group": a["loop_ms_per_step"],
            "capture_seconds": g["capture_seconds"],
            "capture_seconds_no_group": a["capture_seconds"]}


def _timed_rank_steps(cfg, mesh, x, y) -> dict:
    """Median ms of DP_TIMED_STEPS eager bfloat16 rank steps (after two),
    by CUDA events around each step's host call (a rank's step reads its
    collectives' results before it returns)."""
    from tpu_resnet_torch.train.loop import build_state

    state = build_state(cfg, torch.device("cuda"))
    step = rank_step(cfg, state, mesh)
    times = []
    for i in range(DP_TIMED_STEPS + 2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        step(state, x, y)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    return {"ms_per_step_median": statistics.median(times),
            "ms_per_step_min": min(times), "steps": len(times)}


def gloo_rank_parts(mesh, counters) -> dict:
    """(b) and (c) on one rank of a gloo group whose ranks share the card.

    (b) the fused per-replica step at this rank's 64 rows of 128: kernels
    against the plain versions within ``compare_step``'s gates (its
    control: 4x), the launches equal to the one-card step's table, and the
    bfloat16 step's time. (c) synced BN, unfused: the 2-rank step against
    the 1-rank step on the whole batch within the step limits or 4x the
    control (the 1-rank step on PyTorch's own convolutions), and zero1
    against replicated at 2 ranks within ZERO1_TOL."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.train.loop import build_state

    cuda = torch.device("cuda")
    f32 = ["model.compute_dtype=float32"]
    fused = compare_step(load_config("cifar10", "", [*DP_FUSED, *f32]),
                         counters, "cifar10_fused_train", mesh=mesh)
    lo, hi = mesh.rank_rows(TRAIN_BATCH)
    cfg = load_config("cifar10", "", DP_FUSED)
    x, y = step_batch(cfg, TRAIN_BATCH)
    fused["timed_bf16"] = _timed_rank_steps(cfg, mesh, x[lo:hi], y[lo:hi])

    x, y = step_batch(load_config("cifar10", "", DP_SYNCED), TRAIN_BATCH)
    runs = {}
    for arm, rows, ctx, layout in (
            ("two_ranks", (lo, hi), contextlib.nullcontext, mesh),
            ("one_rank", (0, TRAIN_BATCH), contextlib.nullcontext, None),
            ("control", (0, TRAIN_BATCH), plain_native_convs, None),
            ("zero1", (lo, hi), contextlib.nullcontext, mesh)):
        cfg = load_config("cifar10", "", [*DP_SYNCED, *f32, *(
            ["mesh.partition=zero1"] if arm == "zero1" else [])])
        state = build_state(cfg, cuda)
        step = rank_step(cfg, state, layout)
        zero_counts(counters)
        with ctx():
            m = step(state, x[rows[0]:rows[1]], y[rows[0]:rows[1]])
        torch.cuda.synchronize()
        runs[arm] = (state, {k: float(v) for k, v in m.items()},
                     read_counts(counters))
    two = step_diff(runs["two_ranks"], runs["one_rank"])
    control = step_diff(runs["control"], runs["one_rank"])
    ok = (all(two[f"{k}_rel_err"] <= STEP_RTOL for k in ("loss", "precision"))
          and two["worst_err_over_limit"]
          <= CONTROL_FACTOR * max(control["worst_err_over_limit"], 1.0))
    check(ok, f"(c) 2-rank synced step beyond the step limits and "
          f"{CONTROL_FACTOR} x the control: {two} / {control}")
    (zs, zm, _), (rs, rm, _) = runs["zero1"], runs["two_ranks"]
    atol, rtol = ZERO1_TOL
    zb, rb = zs.momentum_buffers(), rs.momentum_buffers()
    pairs = [*((zs.model.state_dict()[n], t)
               for n, t in rs.model.state_dict().items()),
             *((zb[n], rb[n]) for n in rb)]
    zero1_excess = max(float(((g - w).abs() / (atol + rtol * w.abs())).max())
                       for g, w in pairs)
    zero1_metrics = {k: _rel(zm[k], rm[k])
                     for k in ("loss", "precision", "grad_norm")}
    check(zero1_excess <= 1 and max(zero1_metrics.values()) <= rtol,
          f"(c) zero1 vs replicated: {zero1_excess} {zero1_metrics}")
    return {"b": fused,
            "c": {"two_vs_one_rank": two, "control_vs_one_rank": control,
                  "control_factor": CONTROL_FACTOR,
                  "launches_two_ranks": {
                      k: n for k, n in runs["two_ranks"][2].items() if n},
                  "zero1_vs_replicated_err_over_limit": zero1_excess,
                  "zero1_vs_replicated_metrics_rel_err": zero1_metrics,
                  "zero1_tol": ZERO1_TOL}}


def dp_train(overrides, steps: int, log_every: int, train_dir: str,
             counters, context=contextlib.nullcontext) -> dict:
    """``train()`` of CIFAR-10 ResNet-50 with ``overrides`` into
    ``train_dir``, eager (``train.steps_per_call=1``), one checkpoint at
    its end: its end state by name (on the host; under zero1 the whole
    momentum buffers, gathered by every rank), launch counts and
    seconds."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.train.loop import train

    cfg = load_config("cifar10", "", [
        *overrides, f"train.train_dir={train_dir}",
        f"train.train_steps={steps}", f"train.log_every={log_every}",
        f"train.checkpoint_every={steps}", "train.steps_per_call=1"])
    zero_counts(counters)
    t0 = time.monotonic()
    with context():
        state = train(cfg, device="cuda")
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    check(state.step == steps, f"train() stopped at {state.step}")
    return {"tensors": {n: t.detach().cpu().clone()
                        for n, t in state_tensors(state, []).items()},
            "launches": read_counts(counters), "train_seconds": seconds}


def gloo_rank(rank: int, store: str, out_dir: str) -> None:
    """One spawned rank of parts (b) and (c): gloo on CUDA tensors, both
    ranks on card 0, eager (gloo cannot be captured). After the steps,
    the DP_TRAIN_RUNS through ``train()``: each rank's end state goes to
    ``rank<r>_<run>.pt`` for the parent to compare."""
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.parallel import multihost

    resolve_device("cuda")
    mesh = multihost.initialize(f"file://{store}", 1, 0, local_rank=rank,
                                local_world=DP_RANKS, device_type="cuda",
                                backend="gloo", card=0, timeout_sec=600)
    counters = kernel_counters()
    try:
        out = gloo_rank_parts(mesh, counters)
        out["train"] = {}
        for run, (overrides, steps, log_every) in DP_TRAIN_RUNS.items():
            got = dp_train(overrides, steps, log_every,
                           os.path.join(out_dir, run), counters)
            torch.save(got.pop("tensors"),
                       os.path.join(out_dir, f"rank{rank}_{run}.pt"))
            out["train"][run] = got
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_train_check(ranks: list, out_dir: str, counters) -> dict:
    """The gloo ranks' ``train()`` runs: both ranks end in the same state
    bit for bit; each rank's launches are its steps times the one-card
    step's table (the fused run); the run directory holds what a 1-rank
    run's holds, one checkpoint, and one metrics record per logged step
    (rank 0 wrote them, rank 1 nothing). The synced zero1 run against the
    1-rank ``train()`` of its config (DP_ONE_RANK, replicated: one rank's
    update is the plain one) within CONTROL_FACTOR times the normwise
    distance of the control, that 1-rank run on the plain versions and
    PyTorch's own convolutions."""
    overrides, steps, log_every = DP_TRAIN_RUNS["c_zero1_synced"]
    one_rank = {}
    for arm, context in (("one_rank", contextlib.nullcontext),
                         ("control", plain_native_convs)):
        run_dir = os.path.join(out_dir, f"one_rank_{arm}")
        one_rank[arm] = dp_train([*overrides, *DP_ONE_RANK], steps,
                                 log_every, run_dir, counters, context)
        one_rank[arm]["files"] = sorted(os.listdir(run_dir))
        recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
        one_rank[arm]["tensors"].update(metric_tensors(recs))
    own_files = [f for f in one_rank["one_rank"]["files"]
                 if not f.isdigit()]
    out = {}
    for run, (_, steps, log_every) in DP_TRAIN_RUNS.items():
        run_dir = os.path.join(out_dir, run)
        got = [torch.load(os.path.join(out_dir, f"rank{r}_{run}.pt"))
               for r in range(DP_RANKS)]
        same = (set(got[0]) == set(got[1])
                and all(torch.equal(t, got[1][n]) for n, t in got[0].items()))
        check(same, f"{run}: the ranks end in different states")
        recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
        logged = [r["step"] for r in recs]
        files = sorted(os.listdir(run_dir))
        check(logged == list(range(log_every, steps + 1, log_every)),
              f"{run}: metrics.jsonl steps {logged}")
        check(files == sorted([*own_files, str(steps)]),
              f"{run}: files {files}, a 1-rank run writes {own_files}")
        launches = [r["train"][run]["launches"] for r in ranks]
        if "fused" in run:
            want = {k: n * steps for k, n in
                    PER_PASS["cifar10_fused_train"].items()}
            check(all(c == want for c in launches),
                  f"{run}: launches {launches}, expected {want} a rank")
        out[run] = {"steps": steps, "files": files, "logged_steps": logged,
                    "ranks_bit_equal": same,
                    "launches": [{k: n for k, n in c.items() if n}
                                 for c in launches],
                    "train_seconds": [r["train"][run]["train_seconds"]
                                      for r in ranks],
                    "loop_ms_per_step": 1e3 * (recs[-1]["wall"]
                                                - recs[0]["wall"])
                    / (recs[-1]["step"] - recs[0]["step"])}
        if run == "c_zero1_synced":
            got[0].update(metric_tensors(recs))
            two = run_distance(got[0], one_rank["one_rank"]["tensors"])
            control = run_distance(one_rank["control"]["tensors"],
                                   one_rank["one_rank"]["tensors"])
            check(two["worst_rel"]
                  <= CONTROL_FACTOR * control["worst_rel"],
                  f"{run}: 2 ranks against 1 rank {two}, control {control}")
            out[run].update(two_vs_one_rank=two,
                            control_vs_one_rank=control,
                            control_factor=CONTROL_FACTOR)
    return out


def nccl_rank(rank: int, store: str, out_dir: str) -> None:
    """One spawned rank of part (d): NCCL, one card a rank, the fused
    per-replica step gate and its eager bfloat16 time."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.parallel import multihost

    resolve_device("cuda")
    mesh = multihost.initialize(f"file://{store}", 1, 0, local_rank=rank,
                                local_world=DP_RANKS, device_type="cuda",
                                timeout_sec=600)
    try:
        fused = compare_step(load_config("cifar10", "", [
            *DP_FUSED, "model.compute_dtype=float32"]), kernel_counters(),
            "cifar10_fused_train", mesh=mesh)
        lo, hi = mesh.rank_rows(TRAIN_BATCH)
        cfg = load_config("cifar10", "", DP_FUSED)
        x, y = step_batch(cfg, TRAIN_BATCH)
        fused["timed_bf16"] = _timed_rank_steps(cfg, mesh, x[lo:hi],
                                                y[lo:hi])
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(fused, f)


def spawn_ranks(fn, out_dir: str) -> list:
    """Run ``fn(rank, store, out_dir)`` on DP_RANKS spawned processes;
    each rank's JSON. A rank that fails ends the others and raises."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(os.path.join(out_dir, "store"), out_dir),
                       nprocs=DP_RANKS, join=True, start_method="spawn")
    out = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def data_parallel_phase(counters, gpu: str, fused_graphed: dict) -> None:
    """The port's data parallelism on the card: (a) NCCL at one rank,
    graphed, bit for bit the chunked_train phase's run without a group
    (``fused_graphed``); (b) and (c) two gloo ranks on the one card (NCCL
    refuses two ranks on one card), their steps and ``train()`` runs;
    (d) two NCCL ranks on two cards where there are two."""
    t0 = time.monotonic()
    emit("data_parallel", **nccl_world1_part(counters, gpu, fused_graphed),
         part_seconds=time.monotonic() - t0)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out_dir:
        ranks = spawn_ranks(gloo_rank, out_dir)
        runs = dp_train_check(ranks, out_dir, counters)
    emit("data_parallel", part="b_gloo_2_ranks_fused_per_replica", gpu=gpu,
         ranks=[r["b"] for r in ranks], train=runs["b_fused_per_replica"],
         part_seconds=time.monotonic() - t0)
    emit("data_parallel", part="c_synced_bn_and_zero1", gpu=gpu,
         ranks=[r["c"] for r in ranks], train=runs["c_zero1_synced"])
    if torch.cuda.device_count() >= DP_RANKS:
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out_dir:
            ranks = spawn_ranks(nccl_rank, out_dir)
        emit("data_parallel", part="d_nccl_2_cards", gpu=gpu, ranks=ranks,
             part_seconds=time.monotonic() - t0)
    else:
        print(json.dumps({"data_parallel_nccl_2": "not run: 1 card"}),
              flush=True)


# The fleet phase: the serving fleet on the card. ImageNet ResNet-50 fused
# (10 bottleneck_fwd + 19 sbr a forward), a seeded checkpoint, two
# replicas behind ``python -m tpu_resnet_torch route`` with ``fleetmon``
# scraping them, both host processes of their own. (a) The replicas are
# PredictServers in this process, so that the launch counters see their
# forwards; (b) they are ``serve`` processes.
FLEET_OVERRIDES = ["model.fused_blocks=true", "model.fused_epilogue=on",
                   "serve.host=127.0.0.1", "serve.port=0"]
FLEET_REQUESTS, FLEET_THREADS, FLEET_SIZES = 64, 8, (1, 16)
FLEET_PROBE_S = 0.3          # the router's probe interval
FLEET_EXCLUDE_S = 1.5        # (b): r0 out of rotation this soon after death
FLEET_EXACT = 4              # (b): requests of one bucket (16), bit for bit
FLEET_LAT = {1: 30, 16: 16}  # (b): sequential latency requests per N
FLEET_LOAD = ["--clients", "8", "--duration", "8", "--deadline-ms", "30000"]
FLEET_START_S = 300          # a process's readiness limit


def fleet_spawn(d: str, name: str, args: list, extra_env=None):
    """A ``python -m tpu_resnet_torch`` child with its output in
    ``<d>/<name>.log`` (``extra_env``: a fault plan's variables)."""
    from tpu_resnet_torch.hostenv import REPO_ROOT, child_env
    log = open(os.path.join(d, f"{name}.log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_resnet_torch", *args],
        env=child_env(extra_env), cwd=REPO_ROOT, stdout=log,
        stderr=subprocess.STDOUT)


def fleet_tail(d: str, name: str) -> list:
    try:
        with open(os.path.join(d, f"{name}.log")) as f:
            return f.read().strip().splitlines()[-8:]
    except OSError:
        return []


def get_json(url: str, timeout: float = 5.0) -> tuple:
    """(HTTP status, JSON body) of a GET; (None, {}) when it cannot
    connect."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except OSError:
        return None, {}


def route_post(port: int, images) -> tuple:
    """POST /predict?logits=1 of uint8 images [N,H,W,3]; (status, body,
    headers, seconds), HTTP errors returned, not raised."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict?logits=1", data=images.tobytes(),
        headers={"Content-Type": "application/octet-stream",
                 "X-Shape": ",".join(map(str, images.shape))})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, body, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, body, headers = e.code, e.read(), e.headers
    return status, json.loads(body), dict(headers), time.perf_counter() - t0


def scrape_text(port: int) -> tuple:
    """(gauges, histograms) of an endpoint's /metrics."""
    from tpu_resnet_torch import obs
    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=10).read().decode()
    return obs.parse_prometheus(text), obs.parse_histograms(text)


def wait_until(cond, seconds: float, what: str, procs=()) -> None:
    """Poll ``cond`` every 0.2 s; fail after ``seconds`` or when one of
    ``procs`` (name, Popen, dir) has exited."""
    deadline = time.monotonic() + seconds
    while not cond():
        for name, proc, d in procs:
            check(proc.poll() is None, f"{what}: {name} exited "
                  f"{proc.returncode}: {fleet_tail(d, name)}")
        check(time.monotonic() < deadline, f"{what}: not within {seconds} s")
        time.sleep(0.2)


def maps_of(pid: int) -> dict:
    """Whether the process maps the CUDA driver and torch's libraries."""
    with open(f"/proc/{pid}/maps") as f:
        text = f.read()
    return {"libcuda": "libcuda.so" in text, "libtorch": "libtorch" in text}


def compute_apps() -> dict:
    """``nvidia-smi --query-compute-apps=pid,used_memory``: {pid: MiB}."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = mem.strip()
    return apps


def host_only(procs: dict, replicas: dict) -> dict:
    """The router and fleetmon hold no CUDA context and load no torch; the
    replicas map the driver. ``nvidia-smi`` lists the replicas' pids and
    not the host processes' where its pids are this namespace's (it lists
    this process, which holds a context)."""
    maps = {name: maps_of(p.pid) for name, p in {**procs, **replicas}.items()}
    for name in procs:
        check(not any(maps[name].values()),
              f"{name} maps {maps[name]}: a host process touched CUDA/torch")
    for name in replicas:
        check(maps[name]["libcuda"], f"replica {name} does not map libcuda")
    apps = compute_apps()
    visible = os.getpid() in apps
    if visible:
        check(not any(p.pid in apps for p in procs.values()),
              f"nvidia-smi lists a host process: {apps}")
        check(all(p.pid in apps for p in replicas.values()),
              f"nvidia-smi misses a replica: {apps}")
    return {"maps": maps, "compute_apps_mib": {str(k): v
                                               for k, v in apps.items()},
            "pids": {n: p.pid for n, p in {**procs, **replicas}.items()},
            "pids_visible_to_nvidia_smi": visible}


def fleet_view(fleet_port: int, replica_ports: dict, watched) -> dict:
    """fleetmon's merged fleet percentiles, once a scrape round has seen
    every request the replicas' own ``serve_latency_ms`` histograms
    count, beside each replica's own p99."""
    from tpu_resnet_torch.obs.server import histogram_quantile
    ns = "tpu_resnet_"
    own = {n: scrape_text(p)[1][ns + "serve_latency_ms"]
           for n, p in replica_ports.items()}
    total = sum(h["count"] for h in own.values())
    fm = {}

    def merged() -> bool:
        fm.update(scrape_text(fleet_port)[0])
        return fm.get(ns + "fleet_requests_total") == total

    wait_until(merged, 10, "fleetmon's merged count", watched)
    return {"fleet_requests_total": total,
            "fleet_p50_ms": fm[ns + "fleet_serve_p50_ms"],
            "fleet_p99_ms": fm[ns + "fleet_serve_p99_ms"],
            "replica_p99_ms": {n: histogram_quantile(h, 0.99)
                               for n, h in own.items()},
            "replica_requests": {n: h["count"] for n, h in own.items()}}


def lat_ms(samples: list) -> dict:
    s = sorted(samples)
    return {"n": len(s), "p50_ms": 1e3 * statistics.median(s),
            "p99_ms": 1e3 * s[min(len(s) - 1, int(0.99 * len(s)))]}


def fleet_phase(counters, gpu: str) -> dict:
    """The serving fleet (``serve/router.py``, ``obs/fleet.py``,
    ``tools/loadgen.py``) in front of ImageNet ResNet-50 replicas on the
    card; the router and fleetmon are processes of their own, started
    first. Returns (a)'s result, whose launches join the kernels line."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.hostenv import run_subprocess
    from tpu_resnet_torch.models import build_model, init_weights
    from tpu_resnet_torch.obs.fleet import read_fleet_port
    from tpu_resnet_torch.obs.manifest import ensure_run_id
    from tpu_resnet_torch.obs.trace import export_trace
    from tpu_resnet_torch.serve.backend import CheckpointBackend
    from tpu_resnet_torch.serve.infer import make_serve_infer
    from tpu_resnet_torch.serve.router import discover_replicas, \
        read_route_port
    from tpu_resnet_torch.serve.server import PredictServer, write_discovery
    from tpu_resnet_torch.train import checkpoint

    ns, cuda = "tpu_resnet_", torch.device("cuda")
    size = SERVE_PATHS["imagenet"]["size"]
    d = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    cfg = load_config("imagenet", "", [*FLEET_OVERRIDES,
                                       f"train.train_dir={d}"])
    run_id = ensure_run_id(d)
    checkpoint.save(d, 1, init_weights(build_model(cfg),
                                       torch.Generator().manual_seed(0)))
    host = {"router": fleet_spawn(d, "router", [
                "route", f"route.discover_dir={d}", "route.host=127.0.0.1",
                "route.port=0", f"route.probe_interval_secs={FLEET_PROBE_S}",
                "route.probe_timeout_secs=2", "route.fail_threshold=1",
                "route.open_secs=2"]),
            "fleetmon": fleet_spawn(d, "fleetmon", [
                "fleetmon", f"fleet.discover_dir={d}", "fleet.host=127.0.0.1",
                "fleet.port=0", "fleet.scrape_interval_secs=0.5"])}
    watched = [(n, p, d) for n, p in host.items()]
    servers, replicas = [], {}
    try:
        # ------------------------------------------- (a) in-process replicas
        for name in ("r0", "r1"):
            rcfg = load_config("imagenet", "", [
                *FLEET_OVERRIDES, f"train.train_dir={d}",
                f"serve.replica_name={name}"])
            servers.append(PredictServer(rcfg, device="cuda").start())
            write_discovery(d, servers[-1].port, run_id=run_id, name=name)
        ports = {}

        def ready(n: int) -> bool:
            ports["route"] = ports.get("route") or read_route_port(d)
            ports["fleet"] = ports.get("fleet") or read_fleet_port(d)
            if not (ports["route"] and ports["fleet"]):
                return False
            _, info = get_json(f"http://127.0.0.1:{ports['route']}/info")
            up = [r for r in info.get("replicas", [])
                  if r["state"] == "closed" and not r["draining"]]
            return (len(up) == n and info.get("image_shape") is not None
                    and get_json(f"http://127.0.0.1:{ports['fleet']}"
                                 "/healthz")[0] == 200)

        wait_until(lambda: ready(2), FLEET_START_S, "(a) fleet readiness",
                   watched)
        rport = ports["route"]
        rng = np.random.default_rng(0)
        batches = [rng.integers(0, 256, (FLEET_SIZES[i % 2], size, size, 3),
                                dtype=np.uint8)
                   for i in range(FLEET_REQUESTS)]

        def served_batches() -> float:
            return sum(scrape_text(s.port)[0][ns + "serve_batches_total"]
                       for s in servers)

        before = served_batches()
        zero_counts(counters)
        with ThreadPoolExecutor(FLEET_THREADS) as pool:
            answers = list(pool.map(lambda im: route_post(rport, im),
                                    batches))
        launches = read_counts(counters)
        forwards = served_batches() - before
        bad = [(i, a[0], a[1]) for i, a in enumerate(answers) if a[0] != 200]
        check(not bad, f"(a) answers other than 200: {bad[:4]}")
        by_replica = {}
        for a in answers:
            by_replica[a[2].get("X-Replica")] = \
                by_replica.get(a[2].get("X-Replica"), 0) + 1
        check(set(by_replica) == {"r0", "r1"},
              f"(a) replicas answering: {by_replica}")
        want = {k: n * int(forwards) for k, n in PER_PASS["imagenet"].items()}
        check(forwards > 0 and launches == want,
              f"(a) launches {launches} over {forwards} forwards the "
              f"replicas' /metrics report, expected {want}")
        # Oracle: the served model through the plain versions.
        infer = make_serve_infer(cfg, cuda)
        with plain_versions():
            want_logits = [infer(servers[0].backend._model, im).float()
                           .cpu().numpy() for im in batches]
        got = np.concatenate([np.asarray(a[1]["logits"]) for a in answers])
        ref = np.concatenate(want_logits)
        check(got.shape == ref.shape and np.isfinite(got).all(),
              f"(a) logits {got.shape}, finite={np.isfinite(got).all()}")
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        check(err <= LOGIT_TOL * scale, f"(a) routed logits differ from the "
              f"plain versions' by {err} (scale {scale})")
        top2 = np.sort(ref, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * err
        check(bool(clear.any()) and bool(
            (got.argmax(-1) == ref.argmax(-1))[clear].all()),
            "(a) argmax differs on an image with a clear margin")
        view = fleet_view(ports["fleet"], {s.cfg.serve.replica_name: s.port
                                           for s in servers}, watched)
        check(view["fleet_requests_total"] == FLEET_REQUESTS,
              f"(a) the replicas' latency counts {view}")
        part_a = {
            "path": "imagenet_fleet", "requests": FLEET_REQUESTS,
            "images": int(sum(b.shape[0] for b in batches)),
            "threads": FLEET_THREADS, "answered_by": by_replica,
            "forwards": forwards, "launches": launches,
            "per_forward": {k: v / forwards for k, v in launches.items()},
            "logits_max_abs_err": err, "logits_scale": scale,
            "logit_tol_fraction": LOGIT_TOL,
            "clear_margin_images": int(clear.sum()),
            **view, "host_processes": host_only(host, {}), "gpu": gpu}
        emit("fleet", part="a_in_process_replicas", **part_a)
        for s in servers:
            check(s.drain(timeout=60), "(a) a replica did not drain")
            s.close()
        servers = []
        for name in ("r0", "r1"):
            os.remove(os.path.join(d, f"serve-{name}.json"))

        # ----------------------------------------- (b) replica processes
        for name in ("r0", "r1"):
            replicas[name] = fleet_spawn(d, name, [
                "serve", "--preset", "imagenet", *FLEET_OVERRIDES,
                f"train.train_dir={d}", f"serve.replica_name={name}"])
        watched += [(n, p, d) for n, p in replicas.items()]
        t0 = time.monotonic()
        wait_until(lambda: len(discover_replicas(d)) == 2 and ready(2),
                   FLEET_START_S, "(b) replica processes ready", watched)
        start_s = time.monotonic() - t0
        procs = host_only(host, replicas)
        urls = {r["name"]: r for r in discover_replicas(d)}
        check({n: urls[n]["pid"] for n in replicas}
              == {n: p.pid for n, p in replicas.items()},
              f"(b) discovery pids {urls}")
        # One bucket's batch a request, sequential: the replica runs it
        # as one forward at that bucket, as the in-process backend here.
        exact_rng = np.random.default_rng(1)
        local = CheckpointBackend(cfg, cuda)
        exact = []
        for _ in range(FLEET_EXACT):
            im = exact_rng.integers(0, 256, (16, size, size, 3),
                                    dtype=np.uint8)
            status, out, _, _ = route_post(rport, im)
            check(status == 200, f"(b) exact request: {status} {out}")
            mine = local.infer(im)
            lg = np.asarray(out["logits"], np.float32)
            exact.append(bool(np.array_equal(lg, mine)))
            check(exact[-1], f"(b) routed logits differ from the in-process "
                  f"kernel forward by {float(np.abs(lg - mine).max())}")
        local.close()
        del local
        lat = {}
        r0_port = int(urls["r0"]["port"])
        for n, reps in FLEET_LAT.items():
            im = exact_rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
            for target, port in (("direct_r0", r0_port), ("router", rport)):
                samples = []
                for _ in range(reps):
                    status, _, _, sec = route_post(port, im)
                    check(status == 200, f"(b) latency request {status}")
                    samples.append(sec)
                lat[f"{target}_n{n}"] = lat_ms(samples)
        view = fleet_view(ports["fleet"], {n: int(urls[n]["port"])
                                           for n in replicas}, watched)
        before_kill = scrape_text(rport)[0]
        # replica_kill: loadgen SIGKILLs r0 (first record) at half time.
        watch = {"dead_at": None, "excluded_at": None}
        r0_url = urls["r0"]["url"]

        def watcher():
            """r0's death: its port refuses; its exclusion: the router's
            route_replicas_healthy at 1."""
            stop_at = time.monotonic() + 60
            while time.monotonic() < stop_at and watch["excluded_at"] is None:
                if watch["dead_at"] is None:
                    try:
                        urllib.request.urlopen(r0_url + "/healthz",
                                               timeout=5).read()
                    except urllib.error.URLError as e:
                        if isinstance(e.reason, ConnectionRefusedError):
                            watch["dead_at"] = time.monotonic()
                    except (ConnectionError, OSError):
                        pass
                elif scrape_text(rport)[0].get(
                        ns + "route_replicas_healthy") == 1.0:
                    watch["excluded_at"] = time.monotonic()
                time.sleep(0.05)

        w = threading.Thread(target=watcher, daemon=True)
        w.start()
        out_json = os.path.join(d, "loadgen_replica_kill.json")
        rc, out = run_subprocess(
            [sys.executable, "-m", "tpu_resnet_torch.tools.loadgen",
             "--url", f"http://127.0.0.1:{rport}", *FLEET_LOAD,
             "--scenario", "replica_kill", "--fleet-dir", d,
             "--out", out_json], timeout=120)
        w.join(timeout=70)
        check(rc == 0 and os.path.exists(out_json),
              f"(b) loadgen exit {rc}: {out.strip().splitlines()[-5:]}")
        with open(out_json) as f:
            lg = json.load(f)
        check(lg["failed"] + lg["timeouts"] + lg["connect_failures"] == 0
              and lg["rejected_429"] == 0 and lg["requests_ok"] > 0,
              f"(b) loadgen failures {lg}")
        check((lg.get("chaos") or {}).get("killed", {}).get("replica")
              == "r0", f"(b) the kill: {lg.get('chaos')}")
        check(replicas["r0"].wait(timeout=30) == -9, "(b) r0 not SIGKILLed")
        check(watch["dead_at"] is not None
              and watch["excluded_at"] is not None,
              f"(b) r0's exclusion was not seen: {watch}")
        excluded_in = watch["excluded_at"] - watch["dead_at"]
        check(excluded_in <= FLEET_EXCLUDE_S, f"(b) r0 out of rotation "
              f"{excluded_in:.2f} s after its death")
        after_kill = scrape_text(rport)[0]
        # The rolling drain of the survivor through the router.
        rc, out = run_subprocess(
            [sys.executable, "-m", "tpu_resnet_torch", "route", "--drain",
             "r1", f"route.discover_dir={d}"], timeout=120)
        check(rc == 0, f"(b) route --drain r1 exit {rc}: "
              f"{out.strip().splitlines()[-3:]}")
        drain = json.loads(next(line for line in reversed(out.splitlines())
                                if line.startswith("{")))
        check(drain.get("ok") and drain.get("replica_gone"),
              f"(b) the drain: {drain}")
        check(replicas["r1"].wait(timeout=60) == 0, "(b) r1's drain exit "
              f"{replicas['r1'].returncode}: {fleet_tail(d, 'r1')}")
        rcs = {}
        for name, proc in host.items():
            proc.send_signal(signal.SIGTERM)
        for name, proc in host.items():
            rcs[name] = proc.wait(timeout=30)
        check(rcs == {"router": 0, "fleetmon": 0},
              f"(b) SIGTERM exits {rcs}")
        _, trace = export_trace(d)
        names = {e["name"] for e in trace["traceEvents"]}
        need = {"route_request", "route_drain", "replica_down",
                "serve_ready", "serve_drain", "fleet_start"}
        check(need <= names, f"(b) trace lacks {sorted(need - names)}")
        ids = trace["metadata"]["source_run_ids"]
        check(ids.get("route") == ids.get("serve") == [run_id],
              f"(b) run ids {ids}, minted {run_id}")
        part_b = {
            "path": "imagenet_fleet_processes", "replicas_ready_s": start_s,
            "exact_requests": FLEET_EXACT, "exact_bit_equal": exact,
            "latency": lat, "fleetmon_before_kill": view,
            "processes": procs,
            "loadgen": {k: lg[k] for k in (
                "requests_ok", "failed", "timeouts", "connect_failures",
                "rejected_429", "throughput_rps", "images_per_sec",
                "latency_ms", "chaos", "router")},
            "failover": {
                "excluded_in_s": excluded_in,
                "probe_interval_s": FLEET_PROBE_S,
                "client_max_ms": lg["latency_ms"]["max"],
                "retries": after_kill[ns + "route_retries_total"]
                - before_kill[ns + "route_retries_total"],
                "replica_errors": after_kill[
                    ns + "route_replica_errors_total"]
                - before_kill[ns + "route_replica_errors_total"]},
            "drain": drain, "r1_rc": replicas["r1"].returncode,
            "exit_codes": rcs,
            "trace_run_ids": ids, "gpu": gpu}
        emit("fleet", part="b_replica_processes", **part_b)
    finally:
        for s in servers:
            s.close()
        for proc in [*host.values(), *replicas.values()]:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(d, ignore_errors=True)
    return part_a


# The autopilot phase: the fleet's control plane on the card. The seeded
# ImageNet ResNet-50 checkpoint of the fleet phase; r0 a ``serve`` process
# slowed by the serve fault (scenarios/autoscale_burst.json's), the router
# (watch-discovery probation), fleetmon and ``python -m tpu_resnet_torch
# autopilot``, whose spawns are ``serve`` processes under the port's
# supervisor. (a) a burst scales the fleet up and calm traffic back down;
# (b) a colocation denial (exit 3) backs the floor's restore off; (c) the
# port's supervisor carries the fused CIFAR trainer across a preemption
# burst.
AP_SLOW_MS = 150        # r0's injected latency a batch (max_batch 2)
AP_SLO_MS = 500         # up band 450 ms (r0 queueing), down band 250 (idle)
AP_BACKOFF_S = 8.0      # (b): the scale-up hold after exit 3
# The router's p99 is over its last 50 answers, so it follows the traffic
# within seconds; a drain waits 30 s after the spawn, past the burst.
AP_ROUTER = ["route.host=127.0.0.1", "route.port=0",
             "route.probe_interval_secs=0.3", "route.probe_timeout_secs=2",
             "route.fail_threshold=2", "route.open_secs=2",
             "route.latency_ring=50"]
AP_CONTROL = [f"autopilot.slo_ms={AP_SLO_MS}", "autopilot.host=127.0.0.1",
              "autopilot.port=0", "autopilot.poll_interval_secs=0.4",
              "autopilot.min_replicas=1", "autopilot.max_replicas=2",
              "autopilot.up_rounds=2", "autopilot.down_rounds=4",
              "autopilot.scale_up_cooldown_secs=5",
              "autopilot.scale_down_cooldown_secs=30",
              f"autopilot.admission_backoff_secs={AP_BACKOFF_S}",
              "autopilot.ready_timeout_secs=240"]
# The loadgen's burst: an open-loop square wave of 0.25x and 2x 16 qps from
# 8 clients in quarters of 6 s (r0 alone serves ~12 requests/s); calm: one
# closed-loop client, so no replica ever queues.
AP_BURST = ["--scenario", "burst", "--clients", "8", "--qps", "16",
            "--duration", "24", "--deadline-ms", "30000"]
AP_CALM = ["--scenario", "steady", "--clients", "1", "--duration", "15",
           "--deadline-ms", "30000"]
AP_TRAIN_STEPS, AP_BURST_EVERY, AP_LOG_EVERY = 60, 20, 10
AP_TRAIN = ["--preset", "cifar10", "model.fused_blocks=true",
            "model.fused_epilogue=on", "optim.use_pallas_xent=on",
            "data.dataset=synthetic", "data.synthetic_learnable=true",
            f"train.train_steps={AP_TRAIN_STEPS}", "train.steps_per_call=10",
            f"train.log_every={AP_LOG_EVERY}"]
AP_BURST_TRAIN = ["resilience.inject_preempt_burst=2",
                  f"resilience.inject_preempt_burst_every={AP_BURST_EVERY}"]
AP_LOSS_RTOL = 1e-6     # the reference's reshape-drill bound


def ap_events(d: str, kind: str = "", name: str = "") -> list:
    """The autopilot's ledger records of ``kind`` (and replica ``name``)."""
    from tpu_resnet_torch.obs.spans import load_spans
    from tpu_resnet_torch.obs.trace import AUTOPILOT_EVENTS_FILE
    return [s for s in load_spans(os.path.join(d, AUTOPILOT_EVENTS_FILE))
            if (not kind or s["span"] == kind)
            and (not name or s.get("name") == name)]


def ap_status(d: str) -> dict:
    try:
        with open(os.path.join(d, "autopilot_status.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def ap_gauges(d: str) -> dict:
    """The autopilot's ``/metrics`` gauges, without the namespace."""
    from tpu_resnet_torch.autopilot.cli import read_autopilot_port
    gauges, _ = scrape_text(read_autopilot_port(d))
    return {k[len("tpu_resnet_"):]: v for k, v in gauges.items()
            if k.startswith("tpu_resnet_autopilot_")}


def kernel_libraries(pid: int) -> list:
    """The port's kernel libraries (``build/tpu_resnet_torch/lib*.so``) that
    the process maps."""
    from tpu_resnet_torch.ops._build import BUILD_DIR
    with open(f"/proc/{pid}/maps") as f:
        paths = {line.split()[-1] for line in f if BUILD_DIR in line}
    return sorted(os.path.basename(p) for p in paths)


def loadgen(url: str, args: list, out_json: str) -> dict:
    """The port's loadgen through the router; every request 200."""
    from tpu_resnet_torch.hostenv import run_subprocess
    rc, out = run_subprocess(
        [sys.executable, "-m", "tpu_resnet_torch.tools.loadgen", "--url",
         url, *args, "--out", out_json], timeout=180)
    check(rc == 0 and os.path.exists(out_json),
          f"loadgen {args[1]} exit {rc}: {out.strip().splitlines()[-5:]}")
    with open(out_json) as f:
        lg = json.load(f)
    check(lg["failed"] + lg["timeouts"] + lg["connect_failures"]
          + lg["rejected_429"] == 0 and lg["requests_ok"] > 0,
          f"loadgen {args[1]}: failures {lg}")
    return {k: lg[k] for k in ("requests_ok", "failed", "timeouts",
                               "connect_failures", "rejected_429",
                               "throughput_rps", "latency_ms")}


def exact_answers(port: int, images, want, what: str) -> list:
    """B=16 requests straight to a replica, each bit for bit ``want``."""
    equal = []
    for im, mine in zip(images, want):
        status, out, _, _ = route_post(port, im)
        check(status == 200, f"{what}: {status} {out}")
        got = np.asarray(out["logits"], np.float32)
        equal.append(bool(np.array_equal(got, mine)))
        check(equal[-1], f"{what}: logits differ from the in-process kernel "
              f"forward by {float(np.abs(got - mine).max())}")
    return equal


def supervised_train_part(counters, gpu: str) -> dict:
    """(c): ``python -m tpu_resnet_torch.tools.supervise`` over the fused
    CIFAR trainer with a preemption burst of 2, against an uninterrupted
    in-process ``train()`` of the same steps from the same seed."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.hostenv import run_subprocess
    from tpu_resnet_torch.train import checkpoint
    from tpu_resnet_torch.train.loop import train

    cut = tempfile.mkdtemp(prefix="chip_smoke_supervised_")
    whole = tempfile.mkdtemp(prefix="chip_smoke_uninterrupted_")
    try:
        t0 = time.monotonic()
        rc, out = run_subprocess(
            [sys.executable, "-m", "tpu_resnet_torch.tools.supervise", "--",
             sys.executable, "-m", "tpu_resnet_torch", "train", *AP_TRAIN,
             *AP_BURST_TRAIN, f"train.train_dir={cut}"], timeout=600)
        supervised_s = time.monotonic() - t0
        children = [int(line.rsplit(" ", 1)[1]) for line in out.splitlines()
                    if "supervised run_id=" in line and " exited " in line]
        check(rc == 0 and children == [42, 42, 0]
              and "command exited 0 after 2 restart(s)" in out,
              f"(c) supervisor exit {rc}, children {children}: "
              f"{out.strip().splitlines()[-6:]}")
        with open(os.path.join(cut, "fault_burst_state.json")) as f:
            burst = json.load(f)
        saved = checkpoint.all_steps_in(cut)
        check(burst == {"fired": 2, "of": 2} and saved[-1] == AP_TRAIN_STEPS,
              f"(c) burst state {burst}, checkpoints {saved}")
        got = {}
        for rec in read_jsonl(os.path.join(cut, "metrics.jsonl")):
            got[rec["step"]] = rec["loss"]
        zero_counts(counters)
        t0 = time.monotonic()
        state = train(load_config("cifar10", "", [*AP_TRAIN[2:],
                                                  f"train.train_dir={whole}"]),
                      device="cuda")
        torch.cuda.synchronize()
        whole_s = time.monotonic() - t0
        launches = read_counts(counters)
        check(state.step == AP_TRAIN_STEPS, f"(c) train() at {state.step}")
        del state
        want = {rec["step"]: rec["loss"]
                for rec in read_jsonl(os.path.join(whole, "metrics.jsonl"))}
    finally:
        shutil.rmtree(cut, ignore_errors=True)
        shutil.rmtree(whole, ignore_errors=True)
    per_step = {k: n * AP_TRAIN_STEPS
                for k, n in PER_PASS["cifar10_fused_train"].items()}
    check(launches == per_step, f"(c) uninterrupted launches {launches}, "
          f"expected {per_step}")
    check(sorted(got) == sorted(want) and len(want) >= 6,
          f"(c) logged steps {sorted(got)} against {sorted(want)}")
    rel = {s: abs(got[s] - want[s]) / max(abs(want[s]), 1e-30) for s in want}
    worst = max(rel.values())
    check(all(np.isfinite(list(want.values()))) and worst <= AP_LOSS_RTOL,
          f"(c) supervised losses against uninterrupted: {rel}")
    gc_collect()
    return {"path": "cifar10_fused_supervised", "children_exit": children,
            "supervisor_exit": rc, "burst": burst, "checkpoints": saved,
            "losses": {str(s): got[s] for s in sorted(got)},
            "uninterrupted_losses": {str(s): want[s] for s in sorted(want)},
            "loss_max_rel_diff": worst, "loss_rtol": AP_LOSS_RTOL,
            "bit_equal": all(got[s] == want[s] for s in want),
            "supervised_s": supervised_s, "uninterrupted_s": whole_s,
            "launches": launches, "eval_launches": {k: 0 for k in KERNELS},
            "launches_per_step": {k: n / AP_TRAIN_STEPS
                                  for k, n in launches.items()}, "gpu": gpu}


def autopilot_phase(counters, gpu: str) -> dict:
    """The autopilot (``autopilot/``) and the supervisor
    (``tools/supervise.py``) on the card: parts (a), (b) and (c) above the
    constants. Returns (c)'s uninterrupted run, whose launches join the
    ``kernels`` line."""
    from tpu_resnet_torch.autopilot.cli import read_autopilot_port
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.models import build_model, init_weights
    from tpu_resnet_torch.obs.fleet import read_fleet_port
    from tpu_resnet_torch.obs.manifest import ensure_run_id
    from tpu_resnet_torch.obs.spans import load_spans
    from tpu_resnet_torch.obs.trace import ROUTE_EVENTS_FILE, export_trace
    from tpu_resnet_torch.serve.backend import CheckpointBackend
    from tpu_resnet_torch.serve.router import read_route_port
    from tpu_resnet_torch.train import checkpoint

    cuda = torch.device("cuda")
    size = SERVE_PATHS["imagenet"]["size"]
    d = tempfile.mkdtemp(prefix="chip_smoke_autopilot_")
    cfg = load_config("imagenet", "", [*FLEET_OVERRIDES,
                                       f"train.train_dir={d}"])
    run_id = ensure_run_id(d)
    checkpoint.save(d, 1, init_weights(build_model(cfg),
                                       torch.Generator().manual_seed(0)))
    gc_collect()
    template = " ".join([
        "{python} -m tpu_resnet_torch serve --preset imagenet",
        *FLEET_OVERRIDES, f"train.train_dir={d}",
        "serve.replica_name={name}"])
    procs, seconds, hold, done = {}, {}, None, False

    def watched():
        return [(n, p, d) for n, p in procs.items()]

    def start_autopilot(name: str, extra: list):
        """An autopilot process, once it has announced itself and written
        its first round (a predecessor's files removed first)."""
        for fn in ("autopilot.json", "autopilot_status.json"):
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(d, fn))
        procs[name] = fleet_spawn(d, name, [
            "autopilot", f"autopilot.discover_dir={d}", *AP_CONTROL, *extra])
        wait_until(lambda: read_autopilot_port(d) and ap_status(d), 60,
                   f"{name}'s first round", watched())

    def stop(name: str) -> int:
        procs[name].send_signal(signal.SIGTERM)
        return procs.pop(name).wait(timeout=60)

    def healthy() -> list:
        _, info = get_json(f"http://127.0.0.1:{read_route_port(d)}/info")
        return sorted(r["name"] for r in info.get("replicas", [])
                      if r["state"] == "closed" and not r["draining"]
                      and not r["pending"])

    def replica_port(name: str):
        try:
            with open(os.path.join(d, f"serve-{name}.json")) as f:
                rec = json.load(f)
            return int(rec["port"]), int(rec["pid"])
        except (OSError, ValueError, KeyError):
            return None

    try:
        # ------------------------------- (a) scale up on a burst, back down
        t_a = time.monotonic()
        free0, total = torch.cuda.mem_get_info()
        procs["r0"] = fleet_spawn(d, "r0", [
            "serve", "--preset", "imagenet", *FLEET_OVERRIDES,
            f"train.train_dir={d}", "serve.replica_name=r0",
            "serve.max_batch=2"],
            extra_env={"TPU_RESNET_FAULT_SERVE_SLOW_MS": str(AP_SLOW_MS)})
        procs["router"] = fleet_spawn(d, "router", [
            "route", "--watch-discovery", f"route.discover_dir={d}",
            *AP_ROUTER])
        procs["fleetmon"] = fleet_spawn(d, "fleetmon", [
            "fleetmon", f"fleet.discover_dir={d}", "fleet.host=127.0.0.1",
            "fleet.port=0", "fleet.scrape_interval_secs=0.5"])
        wait_until(lambda: read_route_port(d) and read_fleet_port(d)
                   and healthy() == ["r0"], FLEET_START_S, "(a) r0 ready",
                   watched())
        r0_mem = free0 - torch.cuda.mem_get_info()[0]
        rport = read_route_port(d)
        start_autopilot("autopilot", [f"autopilot.spawn_cmd={template}"])
        free_before_spawn = torch.cuda.mem_get_info()[0]
        t0 = time.monotonic()
        burst = loadgen(f"http://127.0.0.1:{rport}", AP_BURST,
                        os.path.join(d, "burst.json"))
        check(len(ap_events(d, "autopilot_spawn")) == 1,
              f"(a) spawns during the burst: {ap_events(d, 'autopilot_spawn')}")
        wait_until(lambda: healthy() == ["ap0", "r0"], FLEET_START_S,
                   "(a) ap0 admitted", watched())
        seconds["burst"] = time.monotonic() - t0
        ap0_mem = free_before_spawn - torch.cuda.mem_get_info()[0]
        gauges = ap_gauges(d)
        check(gauges["autopilot_spawns_total"] == 1
              and gauges["autopilot_replicas_healthy"] == 2
              and gauges["autopilot_spawn_failures_total"] == 0,
              f"(a) gauges after the burst {gauges}")
        latency = ap_status(d)["scale_up_latency_ms"]
        check(latency > 0, f"(a) no scale-up latency: {ap_status(d)}")
        ap0_port, ap0_pid = replica_port("ap0")
        spawn = ap_events(d, "autopilot_spawn", "ap0")[0]
        host = {"autopilot": maps_of(procs["autopilot"].pid),
                "supervisor": maps_of(spawn["pid_target"]),
                "router": maps_of(procs["router"].pid)}
        check(not any(v for m in host.values() for v in m.values()),
              f"(a) a host process maps CUDA/torch: {host}")
        libs = kernel_libraries(ap0_pid)
        check(maps_of(ap0_pid)["libcuda"]
              and any(x.startswith("libfused_bottleneck_tc") for x in libs)
              and any(x.startswith("libepilogue") for x in libs),
              f"(a) ap0 maps {maps_of(ap0_pid)}, kernel libraries {libs}")
        # The kernel forward of FLEET_EXACT batches of 16, counted; (b)'s
        # admitted replica answers the same batches.
        exact_rng = np.random.default_rng(2)
        exact = [exact_rng.integers(0, 256, (16, size, size, 3),
                                    dtype=np.uint8)
                 for _ in range(FLEET_EXACT)]
        local = CheckpointBackend(cfg, cuda)
        zero_counts(counters)
        oracle = [local.infer(im) for im in exact]
        oracle_launches = read_counts(counters)
        local.close()
        del local
        gc_collect()
        want = {k: n * FLEET_EXACT for k, n in PER_PASS["imagenet"].items()}
        check(oracle_launches == want, f"(a) oracle launches "
              f"{oracle_launches}, expected {want}")
        ap0_exact = exact_answers(ap0_port, exact, oracle, "(a) ap0")
        t0 = time.monotonic()
        calm = loadgen(f"http://127.0.0.1:{rport}", AP_CALM,
                       os.path.join(d, "calm.json"))
        wait_until(lambda: ap_status(d).get("counters", {}).get("drains")
                   == 1 and ap_events(d, "autopilot_replica_gone", "ap0"),
                   60, "(a) calm drains ap0", watched())
        seconds["calm"] = time.monotonic() - t0
        gone = ap_events(d, "autopilot_replica_gone", "ap0")
        drain = ap_events(d, "autopilot_drain")
        with open(os.path.join(d, "capacity_lease.json")) as f:
            lease = json.load(f)
        status = ap_status(d)
        c = status["counters"]
        check(gone[0]["rc"] == 0 and len(drain) == 1 and drain[0]["ok"]
              and drain[0]["name"] == "ap0",
              f"(a) ap0's supervisor {gone}, drain {drain}")
        check({k: lease[k] for k in ("state", "holder")}
              == {"state": "granted", "holder": "trainer"},
              f"(a) capacity lease {lease}")
        check(status["target"] == 1 and (c["scale_ups"], c["scale_downs"],
                                          c["drains"], c["spawn_failures"])
              == (1, 1, 1, 0), f"(a) autopilot status {status}")
        check(ap_events(d, "autopilot_capacity_grant"),
              "(a) no autopilot_capacity_grant in the ledger")
        admitted = [s.get("replica") for s in load_spans(os.path.join(
            d, ROUTE_EVENTS_FILE)) if s["span"] == "replica_admitted"]
        check("ap0" in admitted, f"(a) router admissions {admitted}")
        gauges = ap_gauges(d)
        _, trace = export_trace(d)
        ids = trace["metadata"]["source_run_ids"]
        lanes = [e["args"]["name"] for e in trace["traceEvents"]
                 if e.get("name") == "process_name"]
        check(ids.get("autopilot") == [run_id]
              and any(x.startswith("autopilot") for x in lanes),
              f"(a) trace run ids {ids}, lanes {lanes}, minted {run_id}")
        seconds["a"] = time.monotonic() - t_a
        part_a = {
            "path": "imagenet_autopilot", "slo_ms": AP_SLO_MS,
            "r0_slow_ms": AP_SLOW_MS, "burst": burst, "calm": calm,
            "scale_up_latency_ms": latency, "status": status,
            "slo_violation_seconds":
                gauges["autopilot_slo_violation_seconds"],
            "replica_seconds": gauges["autopilot_replica_seconds"],
            "utilization": gauges["autopilot_utilization"],
            "ap0_exact_bit_equal": ap0_exact,
            "oracle_launches": oracle_launches, "ap0_kernel_libraries": libs,
            "host_maps": host, "lease": lease, "drain": drain[0],
            "r0_bytes": r0_mem, "ap0_bytes": ap0_mem,
            "trace_run_ids": ids, "seconds": dict(seconds), "gpu": gpu}
        emit("autopilot", part="a_scale_up_and_down", **part_a)

        # ------------------ (b) colocation denied, then the floor restored
        t_b = time.monotonic()
        check(stop("autopilot") == 0, "(a) the autopilot's SIGTERM exit")
        footprint = max(r0_mem, ap0_mem)
        start_autopilot("autopilot_b", [
            "autopilot.replica_prefix=apb", "autopilot.spawn_cmd="
            f"{template} serve.admission_hbm_bytes={footprint}"])
        # Leave the card less headroom than a replica's footprint once r0's
        # memory is back: admission's headroom is 0.95 of the card less
        # what is in use.
        gc_collect()
        free, total = torch.cuda.mem_get_info()
        take = free + r0_mem - int(0.05 * total) - footprint // 2
        check(0 < take < free - (256 << 20), f"(b) cannot take {take} of "
              f"{free} free bytes (footprint {footprint})")
        hold = torch.empty(take, dtype=torch.uint8, device=cuda)
        t_kill = time.time()
        procs["r0"].kill()
        check(procs.pop("r0").wait(timeout=30) == -9, "(b) r0 not SIGKILLed")
        wait_until(lambda: ap_events(d, "autopilot_admission_denied"), 120,
                   "(b) apb0's admission denial", watched())
        first = ap_events(d, "autopilot_spawn", "apb0")[0]
        denied = ap_events(d, "autopilot_admission_denied")
        headroom_left = torch.cuda.mem_get_info()[0] - int(0.05 * total)
        del hold
        hold = None
        gc_collect()
        with open(os.path.join(d, "autopilot_spawn_apb0.log")) as f:
            spawn_log = f.read()
        check(len(denied) == 1 and denied[0]["name"] == "apb0"
              and denied[0]["rc"] == 3
              and spawn_log.count("serve: colocation admission denied")
              == 1
              and "is a stop code" in spawn_log,
              f"(b) denial {denied}: {spawn_log.strip().splitlines()[-4:]}")
        restore_s = first["start"] - t_kill
        check(restore_s < 5.0, f"(b) the floor's restore came "
              f"{restore_s:.2f} s after r0's death")
        wait_until(lambda: ap_events(d, "autopilot_spawn", "apb1"),
                   AP_BACKOFF_S + 30, "(b) the spawn after the backoff",
                   watched())
        again = ap_events(d, "autopilot_spawn", "apb1")[0]
        backoff = again["start"] - denied[0]["start"]
        check(backoff >= AP_BACKOFF_S - 0.5 and len(ap_events(
            d, "autopilot_spawn")) == 3, f"(b) respawn {backoff:.2f} s after "
            f"the denial (backoff {AP_BACKOFF_S} s)")
        wait_until(lambda: healthy() == ["apb1"], FLEET_START_S,
                   "(b) apb1 admitted", watched())
        apb1_port, apb1_pid = replica_port("apb1")
        apb1_exact = exact_answers(apb1_port, exact, oracle, "(b) apb1")
        gauges = ap_gauges(d)
        check(gauges["autopilot_admission_denied_total"] == 1
              and gauges["autopilot_spawns_total"] == 2
              and gauges["autopilot_spawn_failures_total"] == 0,
              f"(b) gauges {gauges}")
        rcs = {"autopilot_b": stop("autopilot_b")}
        wait_until(lambda: not _pid_alive(apb1_pid), 60,
                   "(b) apb1's drain after the autopilot's SIGTERM")
        for name in ("router", "fleetmon"):
            rcs[name] = stop(name)
        check(rcs == {"autopilot_b": 0, "router": 0, "fleetmon": 0},
              f"(b) SIGTERM exits {rcs}")
        seconds["b"] = time.monotonic() - t_b
        part_b = {
            "path": "imagenet_autopilot_admission",
            "admission_hbm_bytes": footprint, "taken_bytes": take,
            "headroom_left_bytes": headroom_left,
            "restore_after_kill_s": restore_s, "denied": denied[0],
            "respawn_after_denial_s": backoff,
            "backoff_s": AP_BACKOFF_S, "apb1_exact_bit_equal": apb1_exact,
            "gauges": {k: gauges[k] for k in (
                "autopilot_admission_denied_total", "autopilot_spawns_total",
                "autopilot_spawn_failures_total",
                "autopilot_scale_up_latency_ms")},
            "exit_codes": rcs, "seconds": dict(seconds), "gpu": gpu}
        emit("autopilot", part="b_admission_backoff", **part_b)
        done = True
    finally:
        hold = None
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
        if not done:  # an autopilot killed here left its spawns' groups
            for spawn in ap_events(d, "autopilot_spawn"):
                with contextlib.suppress(OSError):
                    os.killpg(spawn["pid_target"], signal.SIGKILL)
        shutil.rmtree(d, ignore_errors=True)
    t_c = time.monotonic()
    part_c = supervised_train_part(counters, gpu)
    seconds["c"] = time.monotonic() - t_c
    emit("autopilot", part="c_supervised_preempt_burst",
         **{**part_c, "seconds": dict(seconds)})
    return part_c


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


# Where a JPEG decoder for an ImageNet input pipeline could come from: the
# CUDA toolkit's nvJPEG and the system's libjpeg, headers and libraries.
JPEG_DIRS = {"cuda": ("/usr/local/cuda/include", "/usr/local/cuda/lib64",
                      "/usr/local/cuda/targets/x86_64-linux/include",
                      "/usr/local/cuda/targets/x86_64-linux/lib"),
             "system": ("/usr/include", "/usr/local/include",
                        "/usr/lib/x86_64-linux-gnu", "/usr/lib64",
                        "/usr/local/lib")}
JPEG_NAMES = ("nvjpeg.h", "libnvjpeg.so", "jpeglib.h")


def jpeg_libs() -> dict:
    """{"cuda": [...], "system": [...]}: the paths, in those directories
    (not below them), of ``nvjpeg.h``, ``libnvjpeg.so*`` and
    ``jpeglib.h``."""
    found = {}
    for where, dirs in JPEG_DIRS.items():
        found[where] = sorted(
            os.path.join(d, fn) for d in dirs if os.path.isdir(d)
            for fn in os.listdir(d)
            if fn in JPEG_NAMES or fn.startswith("libnvjpeg.so"))
    return found


# Each kernel: its source in the port and the TPU kernel body it replaces.
KERNEL_SOURCES = (
    ("sbr", "tpu_resnet_torch/csrc/epilogue.cu",
     "tpu_resnet/ops/epilogue.py:110"),
    ("block_fwd", "tpu_resnet_torch/csrc/fused_block_tc.cu",
     "tpu_resnet/ops/fused_block.py:87"),
    ("bottleneck_fwd", "tpu_resnet_torch/csrc/fused_bottleneck_tc.cu",
     "tpu_resnet/ops/fused_bottleneck.py:154"),
    ("sbr_bwd", "tpu_resnet_torch/csrc/epilogue.cu",
     "tpu_resnet/ops/epilogue.py:158"),
    ("xent_fwd", "tpu_resnet_torch/csrc/softmax_xent.cu",
     "tpu_resnet/ops/softmax_xent.py:74"),
    ("xent_bwd", "tpu_resnet_torch/csrc/softmax_xent.cu",
     "tpu_resnet/ops/softmax_xent.py:88"),
    ("block_stats", "tpu_resnet_torch/csrc/fused_block_tc.cu",
     "tpu_resnet/ops/fused_block.py:509"),
    ("block_bwd1", "tpu_resnet_torch/csrc/fused_block_tc.cu",
     "tpu_resnet/ops/fused_block.py:381"),
    ("block_bwd2", "tpu_resnet_torch/csrc/fused_block_tc.cu",
     "tpu_resnet/ops/fused_block.py:409"),
    ("block_bwd3", "tpu_resnet_torch/csrc/fused_block_tc.cu",
     "tpu_resnet/ops/fused_block.py:433"),
    ("bottleneck_stats_a", "tpu_resnet_torch/csrc/fused_bottleneck_tc.cu",
     "tpu_resnet/ops/fused_bottleneck.py:445"),
    ("bottleneck_stats_b", "tpu_resnet_torch/csrc/fused_bottleneck_tc.cu",
     "tpu_resnet/ops/fused_bottleneck.py:464"),
    ("bottleneck_bwd1", "tpu_resnet_torch/csrc/fused_bottleneck_tc.cu",
     "tpu_resnet/ops/fused_bottleneck.py:644"),
    ("bottleneck_bwd2", "tpu_resnet_torch/csrc/fused_bottleneck_tc.cu",
     "tpu_resnet/ops/fused_bottleneck.py:678"),
    ("bottleneck_bwd3", "tpu_resnet_torch/csrc/fused_bottleneck_tc.cu",
     "tpu_resnet/ops/fused_bottleneck.py:729"),
    ("bottleneck_bwd4", "tpu_resnet_torch/csrc/fused_bottleneck_tc.cu",
     "tpu_resnet/ops/fused_bottleneck.py:754"),
    ("sbr_add", "tpu_resnet_torch/csrc/epilogue.cu",
     "tpu_resnet/ops/epilogue.py:116"),
    ("block_bwd", "tpu_resnet_torch/csrc/fused_block_tc.cu",
     "tpu_resnet/ops/fused_block.py:252"),
    ("bottleneck_bwd", ("tpu_resnet_torch/csrc/fused_bottleneck_tc.cu",
                        "tpu_resnet_torch/csrc/bottleneck_wgrad.cu"),
     "tpu_resnet/ops/fused_bottleneck.py:241"),
    # The weight-gradient products inside passes 1-3 (dw3, dw2, dw1) and
    # inside the folded gradient (dW3, dw2, dW1), at their call lines.
    ("bottleneck_wgrad", "tpu_resnet_torch/csrc/bottleneck_wgrad.cu",
     "tpu_resnet/ops/fused_bottleneck.py:662, :701, :745, :339; "
     "tpu_resnet/ops/fused_block.py:381, :409, :252 (C = 128, 256)"))


def path_times(rows) -> dict:
    """One kernel's times summed over one pass of each path it runs on (a
    B=16 forward of a serve path, a B=128 train step)."""
    by_path = {}
    for path in dict.fromkeys(r["path"] for r in rows):
        on_path = [r for r in rows if r["path"] == path]
        library = [r["library_ms"] * r["per_pass"] for r in on_path
                   if r.get("library_ms") is not None]
        by_path[path] = {
            **{key: sum(r[src] * r["per_pass"] for r in on_path)
               for key, src in (("ms", "ms"), ("plain_ms", "plain_ms"),
                                ("call_ms", "call_ms"),
                                ("plain_call_ms", "call_plain_ms"),
                                ("bound_ms", "bound_ms"))},
            **({"floor_ms": sum(r["floor_ms"] * r["per_pass"]
                                for r in on_path)}
               if "floor_ms" in on_path[0] else {}),
            **({"tc_bound_ms": sum(r["tc_bound_ms"] * r["per_pass"]
                                   for r in on_path)}
               if "tc_bound_ms" in on_path[0] else {}),
            "bound_by": on_path[0]["bound_by"],
            # One F.cross_entropy call computes xent_fwd, and one matmul
            # or conv2d_weight call each of bottleneck_wgrad's products (on
            # the operand made beforehand). No single PyTorch call computes
            # the others: relu of an affine is two calls at least, its
            # backward (dx, ds, db) several, the cross-entropy backward
            # softmax and a one-hot subtraction, the basic block five or
            # more, the bottleneck seven; no call returns the fused block's
            # or the fused bottleneck's training sums, or their folded
            # gradients.
            "library_ms": sum(library) if library else None}
    return by_path


def kernel_entries(rows, served, trained) -> list:
    """The ``kernels`` line: each kernel's launches on the main paths (both
    serve phases, and the train and eval runs of both train phases), its
    worst error against the plain version, and its times per path; the
    entry's own times are a train step's where the kernel runs there (the
    fused one first), else its one serve path's."""
    kernels = []
    for kind, source, replaces in KERNEL_SOURCES:
        by_path = path_times([
            r for r in rows if r["kernel"] == kind
            and r["dtype"] == ("float32" if kind.startswith("xent")
                               else "bfloat16")])
        timed = next((p for p in ("imagenet_fused_train",
                                  "cifar10_fused_train", "cifar10_train")
                      if p in by_path), next(iter(by_path)))
        sources = (source,) if isinstance(source, str) else source
        kernels.append({
            "name": kind, "route": "cuda", "source": sources[0],
            **({"sources": list(sources)} if len(sources) > 1 else {}),
            "replaces": replaces,
            "launches": (sum(s["launches"][kind] for s in served)
                         + sum(t["launches"][kind] + t["eval_launches"][kind]
                               for t in trained)),
            "launches_per_forward": {s["path"]: s["per_forward"][kind]
                                     for s in served},
            "launches_per_step": {t["path"]: t["launches_per_step"][kind]
                                  for t in trained},
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == kind),
            **by_path[timed], "timed_path": timed, "by_path": by_path,
            **({"includes": INCLUDES[kind]} if kind in INCLUDES else {})})
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.ops import _build
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    from tpu_resnet_torch.ops import softmax_xent as sx
    from tpu_resnet_torch.ops import wgrad as wg

    resolve_device("cuda")  # TF32 off for the float32 oracle
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    libs = _build.build_all()
    emit("device", gpu=gpu, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=time.monotonic() - t0,
         libraries=sorted(libs))
    emit("jpeg_libs", **jpeg_libs())

    floor = launch_floor_ms()
    emit("launch_floor", gpu=gpu, launch_floor_ms=floor,
         launch_floor_us=floor * 1e3)
    rows = kernel_phase({
        "sbr": (ep.scale_bias_relu, ep.scale_bias_relu_reference),
        "block_fwd": (fb.block_fwd, fb.block_fwd_reference),
        "bottleneck_fwd": (fbn.bottleneck_fwd,
                           fbn.bottleneck_fwd_reference)})
    rows += train_kernel_phase(ep, sx)
    rows += block_train_kernel_phase(fb)
    rows += bottleneck_train_kernel_phase(fbn)
    rows += bottleneck_wgrad_kernel_phase(wg)
    rows += sbr_add_kernel_phase(ep)
    rows += fused_bwd_kernel_phase(fb, fbn)
    for row in rows:
        if row["kernel"] in FLOOR_KERNELS:   # one launch a call
            row["floor_ms"] = floor
    emit("kernels", gpu=gpu, launch_floor_ms=floor, rows=rows)
    nan_phase(gpu)
    counters = kernel_counters()
    served = [serve_phase(path, counters, gpu,
                          keep=path in ("cifar10", "imagenet"))
              for path in SERVE_PATHS]
    served += serve_arms_phase(counters, gpu, served)
    served.append(fleet_phase(counters, gpu))
    supervised = autopilot_phase(counters, gpu)
    trained = [train_phase(path, counters, gpu) for path in TRAIN_PATHS]
    trained.append(supervised)
    trained.append(imagenet_train_phase(counters, gpu))
    trained.append(imagenet_input_phase(counters, gpu, trained[-1]))
    trained.append(imagenet_train_phase(counters, gpu,
                                        "imagenet34_fused_train"))
    fused_graphed = chunked_train_phase(counters, gpu)
    trained.append(observability_phase(counters, gpu))
    trained.append(autotune_phase(counters, gpu))
    trained += ab_phase(counters, gpu)
    trained += [grad_phase(preset, counters, gpu)
                for preset in ("cifar10", "imagenet")]
    cli_phase(counters, gpu)
    data_parallel_phase(counters, gpu, fused_graphed)

    kernels = kernel_entries(rows, served, trained)
    for entry in kernels:
        if entry["name"] in FLOOR_KERNELS:
            entry["launch_floor_ms"] = floor
    kernels.append(next(t["resize_crop"] for t in trained
                        if "resize_crop" in t))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
