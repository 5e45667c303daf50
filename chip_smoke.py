#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from a checkout of the repository (it puts ``src`` on ``sys.path``
itself), imports neither JAX nor the JAX package, and exits non-zero,
printing no result, when no CUDA card is present or any phase fails.

1. Build: every kernel from ``src/repro_torch/kernels/csrc/`` (one nvcc per
   source, all started together: twelve libraries, the eleven TPU
   kernels' and the quantize pass's; ptxas's report below compiles
   beside them); prints the build time,
   ptxas's registers, static shared memory and spills of every kernel of
   tsmt_q8 and tsmt_q8_split (``resources``: none may spill, or their two
   blocks an SM would not hold) and of tsm2l and tsm2l_q8 (reported), the card's name and power limit, and
   the matmul precision flags (TF32 and reduced precision bf16
   reductions off, so the plain versions are exact f32 sums).
2. Kernels: each kernel against its plain version on the card, f32 and
   bf16, at the chatglm3, paper and ragged shapes; one JSON line per case
   with the kernel's, the plain version's and one ``torch.matmul``'s median
   time (CUDA events around the call, so the wrapper's host time is
   inside), the bound, and the worst error; at the main path's shapes also
   ``device_ms``, the kernel's own median device time from
   ``torch.profiler``, ``call_device_ms``, every device kernel and
   memset of the wrapper call summed, and ``library_device_ms``, the
   library call's device time the same way. Each kernel must
   also give bit-identical results on a second launch. tsmt (f32, bf16)
   and tsmt_q8 (f32, bf16 out) spread m over the card in one launch at
   the plan of ``perf_model.tsmt_slices``, printed as ``plan_splits`` on
   every line (a short m plans S = 1); each must equal, bit for bit, its
   split kernel's partials at the plan's S summed slice by slice from f32
   zeros on the card and cast once, plan S > 1 at [65536,128]^T
   [65536,4] and run there within 0.10 ms on the device. A sweep then
   times both at other S (``tsmt_sweep`` lines): at [65536,128]^T
   [65536,4] over the slice length, at [2^20,128]^T [2^20,4] over 1, 2
   and 4 blocks per SM, where the plan's two constants were read from.
   The split kernels
   (tsm2r_split, tsmt_split) are held against their plain (S, ., .) f32
   partials at the PowerSGD, paper and chatglm3 shapes with a pinned S
   (tsmt_split at b = 256 also at S = 1, against the sequential kernel on
   the same rows, and at S = 16, the chooser's pick before it was kept to
   outputs at most 16 wide; tsm2r_split at the paper's shape also at S =
   1 and 8, at (4096, 4000, 16) with S = 5, whose 800-deep slices start
   in the middle of a 64-deep bf16 box, and at n = 1, 3, 4 and 8; every
   tsm2r_split line with its ``body`` from the library's
   ``tsm2r_split_plan``: "skinny" at n <= 16, "simt" at n = 256),
   and sum_partials bit for bit against the slice-order sum
   (``in_slice_order`` and its plain version, f32 and bf16 outputs, at
   ``REDUCE_CASES``: 4-wide, 2-wide and scalar vectors, P off the 16-byte
   grid, S past one chunk), every line's plan from the library's
   ``reduce_plan`` equal to ``perf_model.reduce_plan``, and the dispatch
   path's (2, 16384, 16) f32 within ``REDUCE_MAX_MS`` on the device; a
   ``reduce_sweep`` line times its body, its first body and
   ``torch.sum`` at ``REDUCE_SWEEP``'s stacks, beside the bytes bound and
   the plan, and its variants (chunk 4 against 8, streaming loads on and
   off, threads a block, blocks an SM) at two of them, each bit-equal to
   the slice-order sum. The split kernels' lines add ``op_ms`` (split
   kernel plus epilogue) and ``seq_ms`` (the sequential kernel on the same
   product); ``library_ms`` is one ``torch.matmul`` of the whole product
   (``torch.sum`` for sum_partials). Tolerances are the
   JAX kernel tests' (f32 rtol=1e-3, atol=1e-4; bf16 rtol=atol=2e-2). Those
   were set for reductions of up to ~2048 terms; for a deeper f32 reduction
   atol grows by sqrt(depth / 1024), because the rounding error of an f32
   sum grows as the square root of its length, and two correct sums taken
   in different orders differ by that much near zero. bf16 keeps 2e-2 as
   it is: both sides round their f32 sums to bf16, and one bf16 step is at
   most 2^-7 of the value.
   tsm2r is also held at the training path's shapes: the wk/wv forward of
   a 4096-token microbatch and PowerSGD's P projection; and at rwkv6's
   (``RWKV_TSM2R``, ``at_rwkv_shapes`` on the kernels line): the decay
   LoRA's down projection [8192,2048]·[2048,64] and [4096,2048]·[2048,64]
   and zamba2's shared-LoRA width [8192,2048]·[2048,128] on the wgmma
   body, PowerSGD's P [65536,2048]·[2048,4] on the skinny body, with tsmt
   at its Q [65536,2048]^T [65536,4]; and at zamba2's (``ZAMBA_TSM2R``,
   ``ZAMBA_P``, ``ZAMBA_Q``, ``at_zamba_shapes``): the shared LoRAs' down
   projection [8192,2048]·[2048,128] and [2048,2048]·[2048,128] on the
   wgmma body, tsm2r_split at PowerSGD's P of the shared block
   ([2048,2048]·[2048,4] and [2048,8192]·[8192,4] at S = 16,
   [8192,2048]·[2048,4] at S = 4, ``ZAMBA_P_SPLITS``: the chooser's S on
   the card, the skinny body, the op and the sequential kernel beside
   it) against its plain partials, tsmt at w_down's Q
   [8192,2048]^T [8192,4], and P and Q of embed and lm_head
   ([32000,2048]·[2048,4] on the skinny body, [32000,2048]^T [32000,4],
   ``ZAMBA_HEADS``); and at the MoE paths' (``MOE_TSM2R``,
   ``MOE_ROUTERS``, ``at_moe_shapes``): mixtral's router
   [8192,4096]·[4096,8] and [4096,4096]·[4096,8] on the skinny body,
   deepseek's router [8192,7168]·[7168,256] and MLA's rope key
   [8192,7168]·[7168,64] on the wgmma body, and tsm2r_split at the
   routers of mixtral's prefill, train microbatch and long request at
   the chooser's S (the sequential kernel beside it); and tsmt at
   hubert-train's tree check (``HUBERT_CHECK``, ``at_hubert_shapes``):
   a w_down leaf's checksum [5120,1280]^T [5120,2] f32; and tsm2r and
   tsmt at vision-train's P and Q of embed and lm_head
   (``VISION_HEADS``, ``at_vision_shapes``): [128256,4096]·[4096,4] on
   the skinny body and [128256,4096]^T [128256,4] on the one-launch tsmt,
   f32; each with its device time beside ``torch.matmul``'s, ungated.
   Every tsm2r line carries ``body``, from the library's ``tsm2r_plan`` query: "wgmma" (the
   tensor-core body) for bf16 at [8192,4096]·[4096,256],
   [4096,4096]·[4096,256], the ragged (1000, 776, 200) and the narrowest
   wide output (4096, 4096, 24); "skinny" (the streaming body) for f32
   and bf16 at n <= 16 with k * size a multiple of 16 bytes (P, the
   paper's shape, n = 1, 3 and 8); "simt" for f32 past n = 16, k % 8 != 0
   ((1000, 777, 16), (1000, 777, 200)) and a base address off the 16-byte
   grid (its own line). The two wgmma main-path shapes must run under
   0.26 and 0.128 ms on the device, their f32 CUDA-core floors; P (f32)
   and tsm2r_split f32 at the paper's shape with S = 2 on the skinny body
   within 0.55 ms. A layout probe (A of small integers, B a column
   selection, so the exact answer is known) must come out exact on the
   wgmma body, and on the skinny body at n = 16 and 4, f32 and bf16,
   through tsm2r and through tsm2r_split at S = 3. A sweep
   (``skinny_sweep`` lines) times the skinny body's variants (rows a
   thread, k-splitting groups, stages, producer warps) at tsm2r_split's
   paper shape and at P, beside the bound and the library call, and the
   int8 stage's at P and at [4096,65536]·[65536,16], S = 4, each
   variant bit-equal to the plain version.
   Every tsm2l line carries ``body``, ``grid`` and ``geometry`` (rows a
   thread, k groups, rows a tile, stages) from the library's
   ``tsm2l_plan``, which must equal ``perf_model.tsm2l_plan`` and
   ``tsm2l_stream_geometry``: "stream" (``csrc/tsm2l_stream.cuh``) at n
   <= 16 and k <= 256 with an aligned A (the paper's [2^20,16,16] and
   [10^7,16,16], timed on the device beside ``torch.matmul``, the main
   path's [102400,4,4], k = 77, 3, 129, 1 and 64), "tile" at (10000, 300,
   20) and on an A 4 bytes off the 16-byte grid (its own line). A
   ``tsm2l_sweep`` line times the tile body and the stream body's
   rows-a-thread variants (the paper's tcf) at [10^7,16,16] f32 on the
   device, and bf16 there and at [2^20,16,16] at 4 and 2 rows a thread,
   each within tolerance of the plain version; the default must
   beat the tile body there and stay within 0.60 ms
   (``TSM2L_STREAM_MAX_MS``).
   The five int8 kernels are held against their plain versions on the
   same int8 operands and scales (quantized on the card by
   ``kernels/quant.py``), with f32 and bf16 outputs (the split ones write
   f32 partials), at their main-path shapes, a ragged shape, and a deep
   case whose reduction (over 133,143 terms of one sign, codes near 127)
   would overflow one int32 sum; at the same tolerances, since the integer
   sums are exact and only the folds round; bit-identical repeats. Every
   tsm2r_q8 line carries ``body``, from the library's ``tsm2r_q8_plan``,
   and every tsm2r_q8_split line from ``tsm2r_q8_split_plan``: "wgmma"
   (its s8·s8→s32 tensor-core body, B quantized K-major as ``ops.py``
   does) at [8192,4096]·[4096,256], [4096,4096]·[4096,256], the ragged
   (1000, 784, 200) and the deep (256, 270000, 32); "skinny" (the
   streaming body's int8 stage: exact int32 ``__dp4a`` sums) at n <= 16
   with k % 16 == 0 (``TSM2R_Q8_SKINNY``: P, n = 1, 3 and 8, the deep
   (512, 300000, 4) at S = 1 and 2, and tsm2r_q8_split at
   [4096,65536]·[65536,16] with S = 4, the paper's shape with S = 2 and
   (4096, 4000, 16) with S = 5, whose 800-deep slices start mid-box);
   "simt" at (1000, 777, 17) (k % 16 != 0). The wgmma and skinny cases
   whose slices are up to 131,072 deep must equal the plain version bit
   for bit (one conversion of an exact integer sum), the two wk/wv shapes
   must run under 0.10 and 0.06 ms on the device, and P and
   tsm2r_q8_split's main case within 0.25 ms. An int8 layout probe (A of
   codes, B a column selection, scales 1) must come out exact on the
   wgmma body, and on the skinny body at n = 16 and 4 through tsm2r_q8
   and tsm2r_q8_split at S = 3. Every tsmt_q8 and tsmt_q8_split line
   carries ``body`` from the library's ``tsmt_q8_plan`` /
   ``tsmt_q8_split_plan``, which must equal ``perf_model.tsmt_q8_plan``:
   "packed" (``csrc/tsmt_q8_packed.cuh``: 8 bytes of a row of X a thread
   in one load, four rows a ``__dp4a``) for ``TSMT_Q8_PACKED`` (PowerSGD's
   Q, [65536,128]^T [65536,4], [2^20,128]^T [2^20,4] and the deep
   (300000, 16, 4)), "simt" at (10000, 300, 20) and (1000, 100, 3);
   tsmt_q8_split at Q (S = 8) within 0.18 ms on the device. Its layout
   probe (X of codes, Y one-hot at rows in every position of a 4-row
   packet and in different thread groups and bands, scales 1, so C[:, j]
   = X[r_j, :]) must come out exact at b = 4 and 16 through tsmt_q8 and
   tsmt_q8_split at S = 3, and ``tsmt_q8_sweep`` times the packed body's
   variants (bytes a thread, rows in flight) at Q, each within tolerance
   of the plain version. Every tsm2l_q8 line carries its plan from
   ``tsm2l_q8_plan`` against the same mirror, and the stream body
   (timed at [2^20,16,16] and [10^7,16,16], f32 and bf16 outputs) must
   equal the plain version bit for bit. A row-major B must give the
   K-major B's
   bits through one counted layout copy (``tsm2r_q8_transpose`` lines,
   with the copy's device time). The
   fused quantize pass (``quantize`` lines) must equal the plain code on
   the card, codes and scales bit for bit, for A [8192,4096] bf16 in
   256-row bands, PowerSGD's [65024,4096] f32 operand, a short last band,
   an all-zero band, exact half-step ties, and B per tensor row-major and
   K-major; each line with its device time, its bytes bound and the
   two-pass floor. At the
   main-path shapes they are timed beside their plain version,
   ``torch._int_mm`` followed by the scale fold (``library_ms``; null where
   it refuses the shape or, for TSMT, where the scales vary along the
   reduction) and one ``torch.matmul`` of the dequantized operands in the
   caller's dtype (``library_dq_ms``). Then the whole ``tsmm``/``tsmm_t``
   op under ``quant="int8"`` is held against the f32 product (the JAX
   ``test_quant.py`` max-norm relative criterion: 5%, 6% for bf16) and
   timed; at the serving shape beside the bf16 op and at PowerSGD's P
   and Q beside the f32 op, by events and on the device.
   A ``bound_class`` line gives each main-path shape (``BOUND_SHAPES``:
   wk/wv, P, Q, the TSQR Gram and apply at PowerSGD's P and at
   [2^20,16,16]) its class from ``tsmm.bound_class`` beside the
   kernel's device ms, its bytes and operations bounds and
   ``torch.matmul``'s device ms; a ``threshold_sweep`` line (data for the
   classifier thresholds, routing nothing) tsm2r's and tsm2r_q8's device
   ms beside bf16 ``torch.matmul``'s at ``THRESHOLD_SWEEP``.
3. Dispatch (a path of its own: every launch count is set to 0 just
   before it and read just after), every launch resolved under
   ``GemmPolicy(verify_contracts=True)``: under ``split="never"`` the
   quickstart's shapes
   through ``tsmm``/``tsmm_t`` must route to tsm2r, tsm2l and tsmt on
   executor ``cuda``, tsmt's launch record showing the planned grid
   (a-tiles, b-tiles, S) with ``splits`` 1. A bfloat16·float32 pair and
   a float16 pair per kernel kind (tsm2r, tsm2l, tsmt) must come back in
   the left operand's dtype within the bf16 tolerance of the plain
   version of the widened pair (the kernel phase times each beside the
   bfloat16 pair's op, device to device). Under ``"auto"`` the paper's
   ``[16384^2]·[16384,16]`` must resolve S > 1 and launch tsm2r_split
   (with sum_partials, its launch record at the grid of
   ``perf_model.reduce_plan``), and PowerSGD's ``[65024,4096]^T·
   [65024,4]`` the S its chooser resolves (the one-launch tsmt at S = 1);
   a pinned S = 8 launches tsm2r_split and tsmt_split; under ``"never"``
   the sequential kernels. The same under ``quant="int8"``: "never"
   routes the quickstart's shapes to tsm2r_q8, tsm2l_q8 and tsmt_q8;
   "auto" resolves ``[4096,65536]·[65536,16]`` (32 row tiles) to S > 1 on
   tsm2r_q8_split, PowerSGD's TSMT to the int8 chooser's S and the
   paper's TSM2R to what the int8 chooser picks, and a pinned S = 8 runs
   PowerSGD's TSMT on tsmt_q8_split. The Python mirror of the
   tile table (``core/perf_model.py``) must equal the C grid query of all
   four split libraries, ``perf_model.tsm2r_plan`` the tsm2r,
   tsm2r_split (at S = 2, 5, 8), tsm2r_q8 and tsm2r_q8_split (at S = 2,
   4, 5) libraries' choice of body and grid, and
   ``perf_model.tsmt_q8_plan`` the tsmt_q8 and tsmt_q8_split libraries'
   (b either side of the packed widths, a % 16, bases of X and Y). Every int8 op quantizes
   both operands through the fused pass: its count must be twice the int8
   launches on every path (plus int8 PowerSGD's P and Q of each
   compressed leaf on train-int8), and no path may need a layout copy.
3b. Autotune (``core/autotune.py``; the autotune path, counts zeroed
   before its tabled ops and read after): ``autotune.calibrate`` at the
   card's ``device_spec`` over ``AUTOTUNE_SHAPES`` (the main paths'
   tsm2r, tsmt and tsm2l calls: PowerSGD's P and Q, zamba2's P, the
   ABFT stage, the tree checks, the TSQR apply in f32; the routers and
   wk/wv in bf16; P and Q under quant="int8"), a dtype at a time, merged
   into one table with one global fit. One ``autotune`` line a record:
   the winner's S beside the chooser's, the measured, modelled and
   pick's microseconds, the model's error, and the winner's device time
   by the sleep-gated timer beside the profiler's ``call_device_ms``
   (within ``AUTOTUNE_TIMER_TOL`` where the profiler reads at least
   ``AUTOTUNE_PROFILED_MS``); a ``fit`` line (``launch_s``, ``hbm_bw``,
   the error before and after, per dtype too). Every record must keep
   ``contracts.check_tuning_record`` on the card's limits and
   registered executors, the table must survive a save and load, every
   op under ``tsmm.policy(tuning_table=...)`` must launch at its
   record's S (the path's launches as the records predict) within
   ``TOL`` of its plain version, and without the table every shape must
   resolve and launch at the chooser's S; the phase within
   ``AUTOTUNE_MAX_S``.
4. Serve (the serving main path; counts zeroed before it, read after):
   chatglm3-6b at its published width and depth, bf16,
   random weights from a seeded generator; 4 prompts of 2048 tokens answered
   with 16 greedy tokens, then a sampled run, then once more step by step
   for times (the main path ends here and the launch counts are read). Each
   prefill must launch tsm2r exactly 56 times (wk, wv x 28 layers) and every
   decode projection must go to ``torch-dense``. The kernel arm's prefill
   logits must match a ``policy(mode="dense")`` arm, and the cached decode
   logits the teacher-forced ``model.forward`` logits, within a normalised
   error max|a - b| / max|b| <= 5e-2 (bf16 activations through 28 layers;
   sums in another order round differently).
   Then one prefill and two decode steps are traced with
   ``torch.profiler``: device time by kernel and by category, the number
   of device kernels, and the device's busy share of the unprofiled time.
5. Serve-int8 (a main path of its own; counts zeroed before, read after):
   the same model, its weights turned into int8 records by
   ``quantize_weights`` (embed, lm_head and the stacked biases and norm
   scales: the 3-D layer weights stay dense), served under
   ``GemmPolicy(quant="int8")``: 4 x 2048 prompt tokens and 16 greedy
   tokens, then step by step for times. Each prefill must launch tsm2r_q8
   exactly 56 times and tsm2r never. Prefill logits must equal, bit for
   bit, a scheme arm: the same routing with every wk/wv product taken by
   the JAX int8 scheme written out in this script, apart from
   ``kernels/ops.py`` and ``kernels/quant.py`` (A in zero-padded 256-row
   bands, B per tensor, absmax / 127 by IEEE division, round half to
   even, clip), times the
   plain version's exact integer product. So ``ops.py`` applies the scheme
   and tsm2r_q8 equals its plain version at every prefill launch. The
   logits must also match a ``mode="dense"`` arm on the same records
   within 0.1, the JAX package's criterion for int8 results through
   several products (``test_quant.py:187, 335``): the scheme's int8 K/V
   projections of 28 layers move the logits by about 5% on their own
   (``tests/test_torch_quant.py`` reads the same distance from the JAX
   package's int8 prefill at the smoke size).
   Prints prefill
   ms, decode ms a step, peak memory, the bytes the records hold and the
   dense bytes they replace, and one profiled prefill.
4b. ABFT, serve arm (a path of its own, after phase 4 on its model):
   ``GemmPolicy.abft`` and ``ft/inject.py``. A prefill through a capture
   executor (``register_executor``) finds the first wk call's fault site
   and output; then an unguarded prefill, an ``abft="verify"`` prefill
   (56 guarded tsm2r events, logits bit-equal to the unguarded ones) and
   an ``abft="correct"`` prefill with a ``GemmFault`` flipping the bit
   in f32 bit 29's place (bf16: 13) of the first wk output's largest
   cell, applied once and repaired (logits bit-equal), each timed.
6. Grad: each op's autograd on the card (the backward re-dispatches
   through ``tsmm``) against autograd through its plain version, f32, at
   the kernel tolerances; a directional finite difference of a
   tsm2l-routed loss against a float64 oracle (rtol 1e-2).
7. Train (the training main path; counts zeroed before it, read after):
   chatglm3-6b at its published width with 4 layers, bf16 parameters
   from seed 0, PowerSGD rank 4, 4 microbatches of 2 x 2048 tokens, 3
   steps of ``train_step.make_train_step``, with ``remat`` on (each
   layer's forward runs again in the backward, and each attention kv step
   a third time). Every step must be
   ``step_ok``, compress exactly embed and lm_head, launch tsm2r exactly
   66 times (wk, wv x 4 layers x 4 microbatches, twice, + 2 P
   projections) and the Q projections twice at the S the chooser
   resolves (the one-launch tsmt at S = 1, its plan's slices > 1) and
   no other TSMT kernel; every backward GEMM of wk/wv goes to
   ``torch-dense``. A ``policy(mode="dense")`` arm from the same state and
   batch must match the first step's loss, grad norm and compressed
   embed/lm_head gradients within normalised error 5e-2. Prints step
   time, tokens/s, peak memory (and the train state's share of it), and
   a profiled fourth step's device busy share and device time by kernel.
7b. ABFT, train arms (a path of its own, after phase 7's kernel arm): 3
   steps under ``abft="verify"`` from the kernel arm's state and batches,
   each ``step_ok`` with loss and grad norm bit-equal to the kernel arm's
   and 66 guarded tsm2r and 2 guarded tsmt events (the checksum stages
   printed by route, kernel and shape); the first through the capture
   executor, for the fault site and the operands of the margins. Then,
   from fresh states, one step under "verify" and one under "correct"
   with a flip of the largest cell of the last microbatch's first wk
   output: applied once, landing on the forward's guarded event and the
   remat recompute's; "verify" gives a NaN loss and ``step_ok`` False,
   "correct" the clean step's loss and grad norm bit for bit. Then the
   offline tree API on the state's parameters: ``encode_tree`` (timed),
   ``verify_tree`` clean, and ``verify_and_correct_tree`` after a flip of
   the exponent's top bit in ``embed.table``'s largest cell, which must
   restore every leaf bit for bit. An ``abft_margin`` line gives the
   guard's largest clean ``|c_out - c_ref| / tol`` at serve wk/wv, train
   wk/wv, P and Q on those real operands; a clean detection fails the
   run. The kernel phase times tsmt and tsm2r at the checksum GEMMs'
   shapes (``ABFT_SHAPES``: lines with ``"abft": true``, device and
   library device ms, the bound, the S the dispatcher resolves there)
   and tsmt_q8 at PowerSGD's Q beside its dequantized library call.
7c. Roofline (after phase 7; no card work, under ``ROOFLINE_MAX_S``):
   phase 4's prefill (4 x 2048 tokens, full width and depth) and phase
   7's step (4 layers, PowerSGD rank 4) counted again on meta tensors of
   the same shapes in a world of one (``launch/dryrun.count``, each
   distinct layer once and multiplied: FLOPs and unfused bytes a op, the
   TSM2X calls priced from the dispatcher's record), beside the device
   time by class their ``profile`` lines took (read, not traced again):
   a ``roofline`` line a path with ``compute_s`` (bf16 peak),
   ``compute_s_dtype_peaks``, ``memory_s``, ``dominant``, the counted
   FLOPs beside ``model_flops``, measured and device busy ms,
   ``roofline_share`` (the bound over the device busy time) and, per
   class (library GEMM, TSM2X kernels, elementwise), the counted FLOPs
   and bytes (a TSM2X call's: its operands and output once, and the
   kernel model's bytes beside them), the bound at the class's dtype
   peaks and the measured ms; the model's terms under the H100 data
   sheet's constants.
8. Train-int8 (a main path of its own): the same, inside
   ``GemmPolicy(quant="int8")`` with ``PowerSGDConfig(compress="int8")``.
   Every step launches tsm2r_q8 64 times for wk/wv, the two P projections
   on tsm2r_q8 or tsm2r_q8_split at the S the int8 chooser resolves
   (checked against it), the Q projections twice on tsmt_q8 (S = 1) or
   tsmt_q8_split at the int8 chooser's S, and no f32/bf16 TSM2X kernel. The dense arm (same compress setting, state and
   batch) must match the first step's loss and grad norm within 5e-2 and
   its compressed embed/lm_head gradients within 0.1 (the JAX criterion
   for int8 PowerSGD and int8 gradients).
9. TSQR (a path of its own): ``linalg.tsqr`` at ``TSQR_CASES`` ([65024,4]
   f32, [2^20,16] f32 and bf16) and conditions 1e0, 1e4, 1e6 from a
   seed: ``max|Q^T Q - I|`` within 1e-4 for f32 (0.05 for bf16 input,
   whose Q is bf16), ``|QR - A| / |A|`` and the distance from the
   ``mode="dense"`` arm's Q R within 1e-5 (0.05), R upper with a
   non-negative diagonal, tsm2l and a TSMT kernel launched once a pass
   (``linalg.default_passes``: 3 at [65024,4], 4 at [2^20,16]);
   at condition 1 the factorization's event and device ms beside
   ``torch.linalg.qr``'s (not gated) and, f32, the gradient against the
   dense arm's within 1e-3. Then the train-tsqr arm (its own path): the
   f32 train configuration with ``PowerSGDConfig(orth="tsqr")`` for 2
   steps, each ``step_ok``, launching tsm2l 2 leaves x 3 passes a step,
   a TSMT kernel for each Q and Gram, and tsm2r 66 times.
10. Launch (a path of its own; counts zeroed before each run, read
   after): ``repro_torch.launch.train.main`` on the card, as a user runs
   it, at chatglm3-6b's width with 4 layers (``chatglm3-6b-4l``,
   registered in ``configs.registry._MODULES`` for the phase), 8 x 2048
   tokens, PowerSGD rank 4. A: 3 clean steps. B: ``--chaos-step 1`` (a
   NaN in ``embed.table[0, 0]``, which step 1's batch reads), rolled
   back to the step-0 host snapshot and replayed (steps 0, 1, 1, 2).
   C1: 1 step, ``--ckpt-every 1 --abft-every 2``: the offline ABFT check,
   then a save, durable before the run returns. C2: 3 steps from C1's
   checkpoint (``elastic.restore_state``), snapshots off, a NaN before
   step 1 escalated to ``restore_latest_good`` (step 0) and replayed, the
   check and a save at step 2. (C is two runs: a fault escalates only to
   a committed checkpoint, and a 15.6 GB write outlasts a step.) B and C2
   must count one fault event and one retry and end on A's final loss
   bit for bit; every run must launch tsm2r 66 and tsmt 2 times a step
   it executed, each offline check 4 tsmt and 16 tsmt_split
   (``LAUNCH_CHECK``) and no other kernel. Prints the host's available
   memory and the checkpoint directory's free disk before it, then per
   run the step ms (the watchdog's), the snapshot's seconds and GB, the
   save's seconds to enqueue, to write (the writer thread) and to durable
   (``wait``), the checkpoint read and the write into the live state,
   and the offline check's time and launches; a summary line beside the
   train phase's median step.
10b-e, 10h. The model paths, one serve and one train phase each
   (``model_serve_phase`` and ``model_train_phase``, given a
   ``ModelPath``: ``RWKV_PATH``, ``ZAMBA_PATH``, ``MIXTRAL_PATH``,
   ``DEEPSEEK_PATH``; deepseek serves only).
10b. rwkv-serve (a path of its own; counts zeroed before, read after):
   rwkv6-1.6b at its published width and depth (24 layers, d_model 2048,
   32 heads of 64, d_ff 7168, vocab 65,536, decay-LoRA rank 64, chunk
   32), bf16, weights from seed 0 with the leaves that start constant
   drawn from the seed (``RWKV_B_SCALE``: the LoRA's b, u, w0), 4 prompts
   of 2048 tokens and 16 greedy tokens, a sampled run, then step by step
   for times. Each prefill launches tsm2r 24 times, all on the wgmma
   body at [8192,2048]·[2048,64] (the decay LoRA's down projection);
   every decode projection goes to ``torch-dense``. The prefill logits
   must match a ``mode="dense"`` arm and the cached decode the
   teacher-forced forward within 5e-2, and zeroing every layer's b must
   move the logits 10x further than the dense arm sits and past 5e-2
   (tsm2r's output reaches them). Prints prefill ms, decode ms a step, tokens/s, peak
   memory, the phase's wall time and one profiled prefill and two
   decode steps.
10c. rwkv-train (a path of its own): the same model at full depth,
   PowerSGD rank 4, 8 x 2048 tokens in 4 microbatches, remat on, 3
   steps, each ``step_ok``, compressing exactly embed and lm_head, and
   launching tsm2r 194 times (the LoRA's down projection of 24 layers x
   4 microbatches, forward and remat recompute, on the wgmma body at
   [4096,2048]·[2048,64], and the 2 P on the skinny body at the S the
   chooser resolves) and the 2 Q on the one-launch tsmt (S = 1), nothing
   else (``RWKV_TRAIN_LAUNCHES``, predicted from the classifier and the
   chooser on the card). A dense arm's first step must match the loss
   and grad norm within 5e-2. Prints step times (with the allocator's
   retries and reserved memory after each), tokens/s, peak and state
   memory, the phase's wall time and a profiled fourth step.
10d. zamba-serve (a path of its own): zamba2-1.2b at its published
   width and depth (38 Mamba2 layers, d_model 2048, d_inner 4096, 64
   heads, state 64, chunk 128; the shared attention and SwiGLU block
   after every 6, with per-group LoRAs of rank 128; vocab 32,000), bf16,
   weights from seed 0 with both LoRAs' b drawn from the seed
   (``ZAMBA_B_SCALE``), 4 prompts of 2048 tokens and 16 greedy tokens, a
   sampled run, then step by step for times. Each prefill launches tsm2r
   12 times (6 groups x the attention and FFN LoRAs), all on the wgmma
   body at [8192,2048]·[2048,128]; every decode projection goes to
   ``torch-dense`` (``zamba_decode_gemms``). The prefill logits must
   match a ``mode="dense"`` arm within 5e-2, zeroing every LoRA's b must
   move them 10x further than the dense arm sits and past 5e-2, and the
   cached decode must match a teacher-forced forward of
   ``ZAMBA_FORCED`` tokens (17 chunks of 128) on a ladder of depths (the
   model cut to its first 1, 2 and 4 groups and its tail, then whole;
   ``ZAMBA_LADDER``): at every rung with the weights cast to f32 within
   1e-3 (``ZAMBA_F32_TOL``), and in bf16 no further from that f32
   forward than 1.25 times the bf16 forward is (``ZAMBA_FLOOR_X``) and
   no further from the bf16 forward than that forward is from f32 (the
   bf16 rounding floor grows with depth at full width). Prints prefill
   ms, decode ms a step, tokens/s, peak memory, a ``zamba-ladder`` line,
   the wall time and one profiled prefill and two decode steps.
10e. zamba-train (a path of its own): the same model, PowerSGD rank 4,
   8 x 2048 tokens in its 8 microbatches, remat on (each Mamba2 layer
   checkpointed, the shared block not), 3 steps, each ``step_ok`` with a
   finite loss and gradient norm, compressing embed, lm_head and the
   shared block's seven matrices, and launching what the classifier and
   the chooser on the card predict, which must be
   ``ZAMBA_TRAIN_LAUNCHES``: tsm2r 98 (96 LoRA-down on the wgmma body at
   [2048,2048]·[2048,128], 2 P), tsm2r_split 7 on the skinny body (the
   first main path to run it), the one-launch tsmt 3, nothing else. A
   dense arm's first step must match the loss and grad norm within
   5e-2. Prints step times, tokens/s, peak and state memory, each
   factor's route and S, the wall time and a profiled fourth step.
10h. The MoE paths (each a path of its own, counts zeroed before and read
   after), after zamba-train, at published width with depth cut to
   what one card holds (``MOE_CUTS``, registered as ``LAUNCH_ARCH`` is),
   bf16, seed 0 (``model_serve_phase``): mixtral-serve, mixtral-8x7b's
   first 8 layers, 4 x 2048 prompt tokens and 16 greedy ones, a sampled
   run and the request step by step: every prefill launches its router
   ``[8192,4096]·[4096,8]`` 8 times on tsm2r_split's skinny body at the
   chooser's S (4 on 132 SMs), decode dense; the prefill within
   ``LOGIT_TOL`` of a dense arm (the (token, layer) routes that flip
   between the arms counted), and swapping the router columns of
   experts 0 and 1 must move it ``LORA_X`` times as far and past
   ``LOGIT_TOL``; each MoE layer's drops and largest load at capacity
   1.25; cached decode against the teacher-forced forward on a
   drop-free copy (``DROP_FREE_CF``; the forward must drop nothing) with
   the forward's expert ids pinned, every step within ``LOGIT_TOL`` (the
   bf16 router logits pick another expert where two lie within a
   rounding: the cached path's own differing choices are counted, at
   most ``MOE_FLIP_SHARE`` of the decoded routes), and on an f32 copy of
   the first ``MOE_F32_LAYERS`` layers within ``MOE_F32_TOL``
   (``moe_decode_check``); a profiled prefill. mixtral-long: the same
   model on one 6,144-token request, past its 4,096-token window, so
   every K/V cache is a 4,096-slot ring: 8 router launches at
   [6144,4096]·[4096,8] a prefill, ring decode against the windowed
   forward likewise. mixtral-train: its first 2
   layers through ``model_train_phase`` (PowerSGD rank 4, 8 x 2048
   tokens in 4 microbatches, remat, 3 steps; 16 tsm2r_split at the
   router, 2 tsm2r and 2 tsmt at P and Q of embed and lm_head a step;
   the MoE metrics a step; a dense arm). deepseek-serve: deepseek-v3's
   first 4 layers (3 dense MLA layers, 1 MoE layer of 256 experts;
   ``router_bias`` drawn from the seed): 4 ``wkr`` at
   [8192,7168]·[7168,64] and 1 router at [8192,7168]·[7168,256] a
   prefill on tsm2r's wgmma body; zeroing ``router_bias`` must move the
   logits; the absorbed and the non-absorbed decode each against the
   forward as above (the MoE layer's routes pinned) and against each
   other within ``LOGIT_TOL``, and both against the forward in f32 on
   the 3 dense MLA layers. A
   ``moe`` line reports the four phases' wall times. mixtral-serve and
   deepseek-serve keep their runs in ``SERVE_REF`` for mesh-moe.
10i. The hubert paths (each a path of its own), after the MoE paths:
   hubert-serve, hubert-xlarge at published width and depth (48 layers,
   d 1280, 16 heads of 80, d_ff 5120, 504 classes, frame_dim 512), bf16,
   seed 0 with every GELU MLP bias and LayerNorm scale and bias drawn
   from the seed (``hubert_perturb_``), 4 x 2048 seeded bf16 frames:
   ``model.forward`` (the encode step) timed as a median of 3 after a
   warm-up and profiled once (device ms by kernel, busy share), and a
   prefill; its 289 projections a forward (frame_proj + 48 x 6) all
   dense, no launch; the prefill's logits the forward's last frame's;
   drawing the last frame again moves the first frame's logits (the
   encoder is bidirectional); the logits within ``HUBERT_F32_TOL`` of
   an f32 copy's. hubert-train, ``launch.train.main`` as the launch
   phase calls it at the same size (``HUBERT_TRAIN_ARGV``: 8 x 2048 f32
   frames in 4 microbatches, PowerSGD rank 4, 2 steps, a save after
   each behind the offline ABFT tree check): every loss finite, no
   fault event or retry, PowerSGD's four leaves' factors dense, and the
   run's launches the tree checks' alone: tsmt at every ``ffn.w_down``
   leaf ([5120,1280]^T [5120,2] f32, S = 1), 48 an encode, 192 in all,
   as ``tree_check_prediction`` predicts; step ms, the saves' seconds,
   the state's size and the peak memory. Each phase must finish within
   its limit (``HUBERT_SERVE_MAX_S``, ``HUBERT_TRAIN_MAX_S``).
10j. The vision paths (each a path of its own), after the hubert paths,
   through ``model_serve_phase`` / ``model_train_phase`` with
   ``VISION_PATH``: vision-serve, llama-3.2-vision-11b at published width
   and depth (40 layers: 8 groups of 4 self-attention layers and a gated
   cross-attention layer), bf16, seed 0 with both gates of every cross
   layer drawn from the seed (``vision_perturb_``; at zero they multiply
   the image path away), 4 x 2048 prompt tokens and each request's own
   seeded f32 image embeddings (1601 x 4096), 16 new tokens: no launch,
   264 dense projections a decode step (``vision_decode_gemms``),
   zeroing the gates moves the logits, cached decode within
   ``LOGIT_TOL`` of the teacher-forced forward; ``vision_decode_check``:
   the cross caches f32 (replaced by the prefill, not rounded into the
   bf16 zeros) and untouched by decode, another request's image moves
   the logits and at zero gates leaves them bit for bit, the first group
   copied in f32 within ``VISION_F32_TOL`` (its decode against its
   forward) and the bf16 cut within ``LOGIT_TOL`` of it; a profiled
   prefill and two decode steps. vision-train, the one-group cut
   (``VISION_CUT``, 5 layers, registered as ``LAUNCH_ARCH`` is): 8 x
   2048 tokens and 8 x 1601 of the pipeline's f32 image rows in 4
   microbatches, PowerSGD rank 4 on ``embed`` and ``lm_head`` alone,
   remat, 3 steps, each ``step_ok``, launching
   ``VISION_TRAIN_LAUNCHES`` (P on tsm2r's skinny body, Q on the
   one-launch tsmt at [128256,4096]) as ``train_prediction`` predicts,
   against a dense arm. Each phase under its limit
   (``VISION_SERVE_MAX_S``, ``VISION_TRAIN_MAX_S``).
10f. dist (a path of its own; counts zeroed before, read after): the
   multi-process executors in a world of one under NCCL
   (``init_method="file://"`` on a temporary file; one card, and NCCL
   puts no two ranks on one device) and a ``("data",)`` ``DeviceMesh``.
   With the executor pinned, chatglm3-6b's wk/wv [8192,4096]·[4096,256]
   bf16 on a ``Shard(0)`` A and a replicated B must record an outer
   ``shard_map`` event and an inner ``cuda`` tsm2r on the wgmma body, and
   PowerSGD's Q [65024,4096]^T [65024,4] f32 under ``reduce="psum"``,
   ``"none"`` (``shard_map``) and ``"psum_scatter"``
   (``shard_map-scatter``) an inner tsmt each; every output equal to the
   unsharded dispatch's bit for bit. Then ``compress_tree_sharded`` over
   a chatglm3-6b-4l gradient tree (one backward of the train phase's
   first batch in its microbatches) under gram_schmidt, tsqr (tree TSQR
   of one rank: the local factorization) and int8 (inside
   ``GemmPolicy(quant="int8")``): its gradients and state equal to
   ``compress_tree``'s on the same tree and state bit for bit, and the
   path's launches those the classifier and the chooser predict
   (``dist_launches``). A ``dist`` line prints each sharded call's time
   beside its unsharded counterpart's (CUDA events, and device ms from
   the profiler: null where no session saw device work, and
   ``profiler_sees_device`` says whether one did before and after NCCL
   started), both protocols' compression metrics, and the device time
   of NCCL's ``all_reduce`` at P's shape and ``reduce_scatter_tensor``
   at Q's (DTensor moves nothing on a mesh dim of one rank, so the
   sharded calls run no collective). Then, in the same world, the mesh
   path's first two runs on a ``("data", "model")`` ``(1, 1)`` mesh
   from ``launch.mesh.make_host_mesh`` (``mesh_serve``): pipeline,
   chatglm3-6b's 28 layers as 4 GPipe stages of 7
   (``distributed.pipeline``) over 4 microbatches of 2 x 2048 tokens,
   forward, bit-equal to the sequential forward of each microbatch, 224
   tsm2r as the schedule predicts (each microbatch through each stage
   once, 2 a layer); mesh-serve, chatglm3-6b at published width and
   depth (bf16, seed 0) on DTensor parameters placed by
   ``sharding.make_param_specs``, caches from ``cache_specs``, through
   ``generate`` and ``make_serve_fns(sharded_projections=True)``: the
   serve phase's prompts, its greedy tokens and every step's logits bit
   for bit, 56 tsm2r a prefill, and prefill and decode ms beside the
   plain path's; one more prefill under ``torch.profiler``, its device
   time by class (library GEMM, TSM2X kernels, elementwise) beside phase
   4's plain prefill's (``profile.prefill`` on the mesh-serve line). Then,
   in the same world, mesh-ssm and mesh-moe
   (``mesh_models_phase``, a path each model: ``mesh_rwkv``,
   ``mesh_zamba``; ``mesh_mixtral``, ``mesh_deepseek``): rwkv6-1.6b cut
   to 8 layers, zamba2-1.2b cut to 14 (``SSM_MESH_CUTS``: two groups and
   the tail), mixtral-8x7b-8l and deepseek-v3-671b-4l on DTensor
   parameters, the weights that their serve phases served (built again
   on the card from the same seed and perturbation, ``serve_weights``:
   none is kept on the host; the SSM cuts' from the same seed and
   perturbation at the cut, held against a plain serve of the cut made
   here, ``plain_serve_ref``), on the (1, 1)
   mesh, caches from ``cache_specs``: the plain runs' tokens, every
   step's logits and their one request sampled at temperature 1 bit for
   bit, 8, 4, 8 (tsm2r_split at S = 4 on the skinny body) and 5 tsm2r a
   prefill as the plain prefill launches, every cache entry (the SSM
   states, mixtral's ring K/V, deepseek's latent caches) in its spec's
   placements after the prefill and after the last decode step; rwkv6,
   zamba2 and mixtral each trained at full width and cut depth (rwkv6 4
   layers, zamba2 6: one group with its shared block and LoRAs; mixtral
   2, launching ``MIXTRAL_TRAIN_LAUNCHES`` a step) with PowerSGD rank 4
   in the config's microbatches for 2 steps on DTensors, its losses and
   parameters bit-equal to a plain arm from the same state and batches
   (run twice, before the serve weights are built: within the two plain
   runs' distance if they differ), the launches ``train_prediction``
   gives; and rwkv6's ABFT tree check on its DTensor parameters,
   checksums bit-equal to the plain leaves', passing, and failing after
   ``poison_tree``. Prefill and decode ms beside the plain path's; the
   phases must take under ``MESH_SSM_MAX_S`` and ``MESH_MOE_MAX_S``.
   Then mesh-hubert (path ``mesh_hubert``): hubert-xlarge at full width
   and depth on DTensor parameters on the (1, 1) mesh, the weights
   hubert-serve served, through ``mesh_encode_check`` (no decode): the
   forward's and the prefill's logits bit-equal to hubert-serve's, every
   projection dense, the K/V caches in their specs' placements; the ABFT
   tree check on its DTensor parameters as rwkv6's (48 tsmt an encode);
   trained at 2 layers (``MESH_TRAIN``) for 2 steps on DTensors,
   bit-equal to the plain arm, no launch; under ``MESH_HUBERT_MAX_S``.
   Then mesh-vision (path ``mesh_vision``): the vision cut (5 layers) on
   DTensor parameters on the (1, 1) mesh, held against its plain serve
   run made here (``plain_serve_ref``: no serve phase serves the cut)
   by ``mesh_serve_check`` with the image embeddings placed by
   ``batch_specs`` (tokens, sampled tokens and every step's logits bit
   for bit, no launch, the cross caches in their specs' placements),
   then trained 2 steps on DTensors bit-equal to the plain arm with
   ``VISION_TRAIN_LAUNCHES`` a step; under ``MESH_VISION_MAX_S``.
   The process group is destroyed after.
10g. mesh (the same path, run right after the launch phase;
   ``mesh_launch``): the launcher's ``--distributed`` in a world of one, in this process under torchrun's
   environment (RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, a free
   MASTER_PORT; the launcher starts and destroys its NCCL group) at the
   launch phase's argv: run B must roll back once and end on the launch
   phase's B loss bit for bit, and a 1-step ``--ckpt-every 1`` run
   resumed through ``elastic.restore_state`` to step 3 on its A loss,
   each launching tsm2r 66 and tsmt 2 times a step. The mesh phase must
   take under ``MESH_MAX_S``.
11. Contracts: every launch that a record scope of a path recorded
   (``RECORDED``; the dispatch path's under ``verify_contracts``) must
   keep ``contracts.check_kernel_config`` and ``check_grid`` on this
   card's limits, and its grid must equal ``contracts.launch_grid`` of
   its params and its library's plan query (body too); a ``contracts``
   line reports the launches checked a path and any violation.
12. A ``{"kernels": [...]}`` line: all eleven kernels with their launches
   on each of the thirty-one paths (dispatch, autotune, serve, train,
   serve-int8,
   train-int8, tsqr, train-tsqr, abft-serve, abft-train, launch,
   rwkv-serve, rwkv-train, zamba-serve, zamba-train, mixtral-serve,
   mixtral-long, mixtral-train, deepseek-serve, hubert-serve,
   hubert-train, vision-serve, vision-train, dist, mesh, mesh-rwkv,
   mesh-zamba, mesh-mixtral, mesh-deepseek, mesh-hubert, mesh-vision)
   and their
   numbers at their main-path shape and dtype (tsm2r and tsmt also
   ``at_abft_shapes``)
   (``library_device_ms`` beside ``device_ms``; ``splits`` is the plan's
   S for tsmt and tsmt_q8; ``body`` for tsm2r, tsm2r_split, tsm2r_q8,
   tsm2r_q8_split, tsmt_q8, tsmt_q8_split, tsm2l and tsm2l_q8);
   tsm2r and tsm2r_q8 add their numbers at the training shapes, tsm2r
   and tsmt at rwkv6's (``at_rwkv_shapes``), tsm2r, tsm2r_split and
   tsmt at zamba2's (``at_zamba_shapes``), tsm2r and tsm2r_split at the
   MoE paths' (``at_moe_shapes``: ``MOE_TSM2R``, ``MOE_ROUTERS``), tsmt
   at hubert-train's tree check (``at_hubert_shapes``: ``HUBERT_CHECK``),
   tsm2r and tsmt at vision-train's P and Q (``at_vision_shapes``:
   ``VISION_HEADS``), tsm2l and tsm2l_q8 at the paper's shapes
   (``at_paper_shapes``). A twelfth entry, ``"tpu_kernel": false``, is the quantize pass at the
   serving shape.
13. Last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import typing
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,            # dense tensor-core bf16
              torch.float32: 67e12,              # f32 outside tensor cores
              torch.int8: 1979e12}               # dense tensor-core int8
TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
LOGIT_TOL = 5e-2
# int8 results through several products (int8 gradients, int8 PowerSGD:
# JAX tests/test_quant.py:187, 335), and int8 serving against a dense arm
Q8_GRAD_TOL = 0.1
Q8_REL_TOL = {torch.float32: 0.05, torch.bfloat16: 0.06}
# Device time the one-launch tsmt and tsmt_q8 must stay within at
# [65536,128]^T [65536,4]: 12x below one block per output tile (1.361 and
# 1.236 ms on an H100 80GB HBM3 at 700 W).
TSMT_MAX_MS = 0.10
# Device time tsm2r's bf16 wgmma body must stay under at chatglm3's wk/wv
# shapes: the f32 CUDA-core floor of each (2mkn FLOP at 67 TFLOP/s), which
# only a body on the tensor cores can beat.
TSM2R_MAX_MS = {(8192, 4096, 256): 0.26, (4096, 4096, 256): 0.128}
# bf16 tsm2r cases that take the wgmma body; every other tsm2r case (f32,
# n <= 16, k % 8 != 0, a misaligned base) takes the skinny or the simt body.
TSM2R_WGMMA = {(8192, 4096, 256), (4096, 4096, 256), (1000, 776, 200),
               (4096, 4096, 24), (8192, 2048, 64), (4096, 2048, 64),
               (8192, 2048, 128), (2048, 2048, 128), (8192, 7168, 256),
               (8192, 7168, 64)}
# tsm2r cases that take the skinny body, f32 and bf16 (n <= 16, rows of A
# whole 16-byte chunks, an aligned A); the ragged (1000, 777, 16) stays on
# the simt body, as do f32 outputs wider than 16.
TSM2R_SKINNY = {(65024, 4096, 4), (16384, 16384, 16), (4096, 4096, 8),
                (4096, 4096, 3), (512, 512, 1), (100, 8, 3), (64, 24, 16),
                (65536, 2048, 4), (32000, 2048, 4), (8192, 4096, 8),
                (128256, 4096, 4)}
# Device time the skinny body must stay within, f32: tsm2r_split at
# [16384,16384]·[16384,16], S = 2 (0.675 ms on the simt body), and tsm2r's
# P at [65024,4096]·[4096,4] (0.662), on an H100 80GB HBM3 at 700 W.
SKINNY_MAX_MS = 0.55
# Device time tsm2r_q8's int8 wgmma body must stay under at chatglm3's
# wk/wv shapes: loose gates that the __dp4a body (0.428 and 0.219 ms on an
# H100 80GB HBM3 at 700 W) cannot pass.
TSM2R_Q8_MAX_MS = {(8192, 4096, 256): 0.10, (4096, 4096, 256): 0.06}
# tsm2r_q8 cases that take the wgmma body (n > 16, k % 16 == 0).
TSM2R_Q8_WGMMA = {(8192, 4096, 256), (4096, 4096, 256), (1000, 784, 200),
                  (256, 270000, 32)}
# int8 cases (m, k, n, S) that take the skinny body (n <= 16, k % 16 == 0,
# an aligned A), through tsm2r_q8 (S = 1) and tsm2r_q8_split; the ragged
# (1000, 777, 17) stays on the simt body.
TSM2R_Q8_SKINNY = {(65024, 4096, 4, 1), (4096, 4096, 1, 1),
                   (4096, 4096, 3, 1), (4096, 4096, 8, 1),
                   (512, 300000, 4, 1), (4096, 65536, 16, 4),
                   (16384, 16384, 16, 2), (512, 300000, 4, 2),
                   (4096, 4000, 16, 5)}
# Device time the int8 skinny body must stay within at tsm2r_q8's P
# [65024,4096]·[4096,4] and tsm2r_q8_split's [4096,65536]·[65536,16], S =
# 4: a gate that the __dp4a simt body (0.481 and 0.489 ms on an H100 80GB
# HBM3 at 700 W) cannot pass.
TSM2R_Q8_SKINNY_MAX_MS = 0.25
# int8 TSMT cases (m, a, b) that take the packed body (b in {4, 8, 12,
# 16}, a % 16 == 0, aligned X and Y), through tsmt_q8 and tsmt_q8_split
# at every S; (10000, 300, 20) and (1000, 100, 3) stay on the simt body.
TSMT_Q8_PACKED = {(65536, 128, 4), (300000, 16, 4), (65024, 4096, 4),
                  (1 << 20, 128, 4)}
# Device time tsmt_q8_split must stay within at PowerSGD's Q
# [65024,4096]^T [65024,4], S = 8: a gate that the simt body (0.266 ms on
# an H100 80GB HBM3 at 700 W) cannot pass.
TSMT_Q8_SPLIT_MAX_MS = 0.18
# Device time tsm2l's stream body must stay within at the paper's
# [10^7,16,16] in f32: below the tile body there (0.69 ms by CUDA events
# around the call on an H100 80GB HBM3 at 700 W), which the same run also
# times and must beat.
TSM2L_STREAM_MAX_MS = 0.60
# sum_partials' cases (S, rows, cols, floats P lies past a 16-byte
# boundary): the dispatch path's stack first; rows * cols % 4 == 2 (2-wide
# vectors) and odd (one output a thread); S past one 8-slice chunk; P 4
# and 8 bytes off the 16-byte grid.
REDUCE_CASES = [(2, 16384, 16, 0), (8, 4096, 4, 0), (32, 128, 4, 0),
                (4, 1002, 3, 0), (3, 1001, 3, 0), (9, 4096, 16, 0),
                (2, 16384, 16, 1), (2, 16384, 16, 2)]
# Device time sum_partials must stay within at the dispatch path's (2,
# 16384, 16) f32: 0.00170 ms on an H100 80GB HBM3 at 700 W, where the first
# body (64 blocks of 4,096 outputs) took 0.0030, which the gate refuses.
REDUCE_MAX_MS = 0.0025
# reduce_sweep's stacks: the launch floor (almost no bytes), the split
# phase's stacks, and one past the 50 MB L2 (67 MB of partials). The
# variants run at the last two.
REDUCE_SWEEP = [((2, 64, 16), torch.float32), ((2, 16384, 16), torch.float32),
                ((2, 16384, 16), torch.bfloat16),
                ((8, 16384, 16), torch.float32),
                ((5, 4096, 16), torch.float32),
                ((16, 256, 256), torch.float32),
                ((4, 8192, 256), torch.float32),
                ((4, 65536, 64), torch.float32)]
REDUCE_VARIANT_STACKS = ((16, 256, 256), (4, 65536, 64))
# The dispatch phase's mixed and float16 pairs: (kind, entry, lhs, rhs).
WIDENED_OPS = (("tsm2r", "mm", (4096, 4096), (4096, 8)),
               ("tsm2l", "mm", (102400, 4), (4, 4)),
               ("tsmt", "mmt", (65536, 128), (65536, 4)))
# Deepest reduction whose s32 sum the wgmma body folds into f32 once, so
# its result is bit-equal to the plain version (1,024 stages of 128 k).
Q8_ONE_FOLD_K = 131072
BATCH, PROMPT, NEW = 4, 2048, 16
# rwkv6-1.6b's kernel shapes: the decay LoRA's down projection [T,2048]·
# [2048,64] at the prefill's 8192 and a train microbatch's 4096 tokens,
# zamba2's shared-LoRA width n = 128 (measured ahead of its port), and
# PowerSGD's P [65536,2048]·[2048,4]; Q is [65536,2048]^T [65536,4].
RWKV_TSM2R = [(8192, 2048, 64), (4096, 2048, 64), (8192, 2048, 128),
              (65536, 2048, 4)]
RWKV_Q = (65536, 2048, 4)
# rwkv6's perturbation of the leaves that start constant: the decay
# LoRA's b (zeros at init, so its product would not reach the logits),
# drawn N(0, 1) * RWKV_B_SCALE * rank^-0.5 (the LoRA's output then has
# a standard deviation of about RWKV_B_SCALE); u (zeros) N(0, 1) * 0.1;
# w0 (-6 everywhere) plus N(0, 1) * 0.5. w0 + the LoRA has a mean of -6
# and a standard deviation of about 0.7: chunk * |logw| would reach exp's
# overflow at ~88 only past w0 + lora = 1, ten standard deviations out
# (mu is already a U[0, 1) draw).
RWKV_B_SCALE = 0.5
# zamba2-1.2b's kernel shapes: the shared LoRAs' down projection
# [T,2048]·[2048,128] at a train microbatch's 2048 tokens (the prefill's
# 8192 is RWKV_TSM2R's third), PowerSGD's P of the shared block's
# matrices on tsm2r_split ([2048,2048]·[2048,4] for wq, wk, wv, wo;
# [2048,8192]·[8192,4] for w_gate, w_up; [8192,2048]·[2048,4] for
# w_down), and Q of w_down [8192,2048]^T [8192,4] on the one-launch tsmt;
# P and Q of embed and lm_head ([32000,2048]·[2048,4] on tsm2r's skinny
# body at S = 1, [32000,2048]^T [32000,4] on the one-launch tsmt).
ZAMBA_ARCH = "zamba2-1.2b"
ZAMBA_TSM2R = (2048, 2048, 128)
ZAMBA_P = [(2048, 2048, 4), (2048, 8192, 4), (8192, 2048, 4)]
ZAMBA_Q = (8192, 2048, 4)
ZAMBA_HEADS = (32000, 2048, 4)
# llama-3.2-vision's: PowerSGD's P and Q of embed and lm_head, f32,
# [128256,4096]·[4096,4] on tsm2r's skinny body and
# [128256,4096]^T·[128256,4] on the one-launch tsmt, the most rows either
# kernel meets on a main path.
VISION_HEADS = (128256, 4096, 4)
# The chooser's S at the three P shapes on 132 SMs (the launch counts
# below follow from it): each split's epilogue is a plain sum
# (S * rows * cols <= 2^18, perf_model.reduce_kernel_runs).
ZAMBA_P_SPLITS = {(2048, 2048, 4): 16, (2048, 8192, 4): 16,
                  (8192, 2048, 4): 4}
# A zamba-train step's launches, predicted from the classifier and the
# chooser: tsm2r 12 LoRA-down a microbatch x 8 + P of embed and lm_head;
# tsm2r_split P of the shared block's seven matrices; tsmt Q of w_down,
# embed and lm_head (the other six Q products are dense).
ZAMBA_TRAIN_LAUNCHES = {"tsm2r": 98, "tsm2r_split": 7, "tsmt": 3}
# The LoRAs' b (zeros at init, so their products would not reach the
# logits), drawn N(0, 1) * ZAMBA_B_SCALE * rank^-0.5: each LoRA's output
# then has a standard deviation of about ZAMBA_B_SCALE. No other leaf is
# moved: A_log and dt_bias keep the reference's init.
ZAMBA_B_SCALE = 0.5
# The teacher-forced forward of zamba-serve: the prompt, the 16 generated
# tokens and 112 more from the seed, 2176 = 17 chunks of 128 (2064 tokens
# would fall to chunks of 86); causal, so the tail moves no earlier logit.
ZAMBA_FORCED = 2176
# Cached decode against that forward, on a ladder of depths: the served
# model cut to its first ZAMBA_LADDER groups and its tail (8, 14 and 26
# layers), then whole. At full width the bf16 forward's own distance from
# the same weights in f32 grows with depth (0.109, 0.163, 0.253, 0.309 of
# the largest logit on an H100 80GB HBM3 at 700 W), so no fixed limit
# fits every rung. At every rung: an f32 copy of the weights must match
# its own forward within ZAMBA_F32_TOL (the cache's logic; read
# 1.6e-5-5.6e-5); the bf16 decode may sit at most ZAMBA_FLOOR_X times as
# far from the f32 forward as the bf16 forward does (read 0.97-1.02
# times), and no further from the bf16 forward than that forward is from
# f32 (read 0.48-0.53 of it): the cache's bf16 numerics.
ZAMBA_LADDER = (1, 2, 4)
ZAMBA_FLOOR_X = 1.25
ZAMBA_F32_TOL = 1e-3
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 2048, 8, 3
TRAIN_TSQR_STEPS = 2
# The tall-skinny QR's cases: PowerSGD's P factor of chatglm3's embed and
# lm_head, and the paper's TSM2L width at 2^20 rows, f32 and bf16 input;
# each at these 2-norm condition numbers.
TSQR_CASES = [(65024, 4, torch.float32), (1 << 20, 16, torch.float32),
              (1 << 20, 16, torch.bfloat16)]
TSQR_CONDS = (1e0, 1e4, 1e6)
# The bound_class line's shapes: (name, entry, (m, d1, d2), dtype), the
# "mmt" ones X[m,a]^T Y[m,b].
BOUND_SHAPES = [("wk/wv", "mm", (8192, 4096, 256), torch.bfloat16),
                ("P", "mm", (65024, 4096, 4), torch.float32),
                ("Q", "mmt", (65024, 4096, 4), torch.float32),
                ("tsqr Gram", "mmt", (65024, 4, 4), torch.float32),
                ("tsqr apply", "mm", (65024, 4, 4), torch.float32),
                ("tsqr Gram", "mmt", (1 << 20, 16, 16), torch.float32),
                ("tsqr apply", "mm", (1 << 20, 16, 16), torch.float32)]
# The threshold sweep: chatglm3's wk/wv rows and depth at widths 16..256,
# and a 16-wide output at shorter m.
THRESHOLD_SWEEP = [(8192, 4096, n) for n in (16, 32, 64, 128, 256)] + [
    (m, 4096, 16) for m in (512, 2048)]
KERNEL_NAMES = ("tsm2r_q8_split", "tsmt_q8_split", "tsm2r_q8", "tsm2l_q8",
                "tsmt_q8", "tsm2r_split", "tsmt_split", "tsm2r", "tsm2l",
                "tsmt", "sum_partials")
Q8_KERNELS = ("tsm2r_q8", "tsm2l_q8", "tsmt_q8", "tsm2r_q8_split",
              "tsmt_q8_split")


T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, min_reps: int = 3) -> float:
    """Median of CUDA-event timings after warm-up."""
    fn()
    torch.cuda.synchronize()

    def once():
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    first = once()
    reps = max(min_reps, min(50, int(200 / max(first, 1e-3))))
    return statistics.median([first] + [once() for _ in range(reps - 1)])


def bound(x, y, out, flops, *extra):
    """The least time for the work: each input (``extra`` too: scale
    sidecars) read once and the output written once, or ``flops`` at the
    peak rate of the inputs' type, whichever is longer."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, y, out, *extra))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check(cond, what) -> None:
    """Fail the run (non-zero exit, no result line) unless ``cond``."""
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def normalised_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def category(name: str) -> str:
    if "tsm2l_kernel<signed char" in name:   # one template serves both
        return "tsm2l_q8"
    if "tsm2l_stream_kernel<signed char" in name:   # the stream bodies
        return "tsm2l_q8"
    if "tsm2l_stream_kernel" in name:
        return "tsm2l"
    if "tsm2r_wgmma_kernel" in name:         # tsm2r's tensor-core body
        return "tsm2r"
    if "tsm2r_q8_wgmma_kernel" in name:      # tsm2r_q8's tensor-core body
        return "tsm2r_q8"
    if "tsm2r_split_skinny_kernel" in name:  # the split kernel's skinny body
        return "tsm2r_split"
    if "tsm2r_skinny_kernel" in name:        # tsm2r's skinny body
        return "tsm2r"
    if "tsm2r_q8_transpose_kernel" in name:  # tsm2r_q8's layout change of B
        return "tsm2r_q8_transpose"
    if "tsm2r_q8_split_skinny_kernel" in name:   # the int8 skinny bodies
        return "tsm2r_q8_split"
    if "tsm2r_q8_skinny_kernel" in name:
        return "tsm2r_q8"
    if "quantize_" in name and "_kernel" in name:   # the fused quantize pass
        return "quantize"
    for kern in KERNEL_NAMES:
        if f"{kern}_kernel" in name:
            return kern
    if any(w in name for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "library GEMM"
    return "other"


def device_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` (device activity only: a train
    step's ~200,000 host op events would take minutes to collect) and
    return the device time by kernel and by category, the number of
    device kernels, and ``runs``: the calls of ``fn`` it took. A trace
    that came back empty is taken again, so past one run the profile
    covers a later call than the first (for a train step, a later
    step)."""
    by_kernel, by_cat, n_kernels, runs = {}, {}, 0, []

    def run():
        runs.append(1)
        fn()

    for e in device_events(run, bool):
        n_kernels += 1
        us = e.time_range.elapsed_us()
        by_kernel[e.name] = by_kernel.get(e.name, 0) + us
        cat = category(e.name)
        by_cat[cat] = by_cat.get(cat, 0) + us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"device_busy_ms": sum(by_kernel.values()) / 1e3,
            "device_kernels": n_kernels, "runs": len(runs),
            "by_category_ms": {k: v / 1e3 for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:90], v / 1e3] for n, v in top]}


def device_events(run, enough, tries: int = 6) -> list:
    """The device events (kernels, memsets) of ``run()`` under
    ``torch.profiler``, in start order. Now and then a session's trace
    comes back without them (three sessions in a row have); a session
    whose events are not ``enough`` is taken again after a short pause,
    up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if enough(events):
            break
    return events


def device_ms(fn, name: str, reps: int = 5) -> float:
    """Median device time of kernel ``name`` over ``reps`` calls of ``fn``
    under ``torch.profiler``: the kernel alone, without the host time
    that CUDA events around the call include."""
    return device_ms_each([fn], name, reps)[0]


def call_device_ms(fn, reps: int = 5) -> float:
    """Device time of one call of ``fn``: every device kernel (and memset)
    it runs, summed, averaged over ``reps`` calls under ``torch.profiler``.
    The library calls are timed so, device to device with ``device_ms``."""
    def run():
        for _ in range(reps):
            fn()

    fn()
    events = device_events(run, bool)
    check(events, f"no device kernel in {reps} profiled calls")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def device_ms_each(fns, name: str, reps: int = 10) -> list:
    """``device_ms`` of each of ``fns`` (median of ``reps`` calls), in one
    profiler session: the kernel events of ``name``, in launch order."""
    def run():
        for fn in fns:
            for _ in range(reps):
                fn()

    def ours(events):
        return [e for e in events if category(e.name) == name]

    for fn in fns:
        fn()
    events = ours(device_events(
        run, lambda ev: len(ours(ev)) == reps * len(fns)))
    check(len(events) == reps * len(fns), f"{name}: {len(events)} device "
          f"kernels in {reps * len(fns)} profiled calls")
    us = [e.time_range.elapsed_us() for e in events]
    return [statistics.median(us[i * reps:(i + 1) * reps]) / 1e3
            for i in range(len(fns))]


def in_slice_order(parts, dtype):
    """The one-launch TSMT's last block written out: the (S, a, b) f32
    partials summed slice by slice from f32 zeros and cast once; at S = 1
    the kernel stores its one partial straight."""
    if parts.shape[0] == 1:
        return parts[0].to(dtype)
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc += p
    return acc.to(dtype)


def same_bits(a, b) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def tsm2l_plan_check(x, y, dtype, q8_out=None) -> dict:
    """tsm2l's (``q8_out``: tsm2l_q8's, writing that dtype) body, grid and
    stream geometry from its library's plan query, against
    ``perf_model.tsm2l_plan`` and ``tsm2l_stream_geometry`` and against
    the body the case must take ("stream" for n <= 16, k <= 256 and an
    aligned A)."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import tsm2l as k_tsm2l

    (m, k), n = x.shape, y.shape[1]
    body, grid, geo = (k_tsm2l.q8_plan(x, y, q8_out) if q8_out is not None
                       else k_tsm2l.plan(x, y))
    spec = perf_model.device_spec(perf_model.H100, x.device)
    mirror = perf_model.tsm2l_plan(m, k, n, dtype, x.data_ptr(), spec,
                                   out_dtype=q8_out)
    if mirror[0] == "stream":
        g = perf_model.tsm2l_stream_geometry(k, n, dtype, q8_out)
        want_geo = (g["rows"], g["groups"], g["block_m"], g["stages"])
    else:
        want_geo = (0, 0, perf_model.tsm2l_tile(n)[0], 0)
    want = ("stream" if n <= 16 and k <= 256 and x.data_ptr() % 16 == 0
            else "tile")
    return {"body": body, "grid": grid, "geometry": geo,
            "plan_ok": (body == want and (body, grid) == mirror
                        and geo == want_geo)}


def abft_kernel_rows(dev, uniform, gpu, kernels) -> dict:
    """The kernels at the shapes the ABFT guard's checksum GEMMs reach
    them (``ABFT_SHAPES``, f32): each against its plain version, timed
    like a main-path row (events, the kernel's and the library call's
    device time, the bound), with the S the dispatcher resolves there
    (``dispatch_splits``; > 1 runs the split kernel and its sum instead:
    the split kernel's partials are held against their plain version and
    the op as dispatched against the product's, each repeated bit for
    bit, and the op is timed as ``dispatch_device_ms``)."""
    from repro_torch.core import tsmm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.kernels import tsmt as k_tsmt

    rows, bad = {}, []
    for name, (m, d1, d2), stages in ABFT_SHAPES:
        kern, plain, library, entry = kernels[name]
        op = tsmm.tsmm if entry == "mm" else tsmm.tsmm_t
        x = uniform((m, d1), torch.float32)
        y = uniform((d1, d2) if entry == "mm" else (m, d2), torch.float32)
        got = kern(x, y)
        again = kern(x, y)
        torch.cuda.synchronize()
        want = plain(x, y)
        depth = d1 if entry == "mm" else m
        rtol, atol = TOL[torch.float32]
        atol *= max(1.0, (depth / 1024) ** 0.5)
        err = (got - want).abs()
        ok = torch.equal(got, again) and bool(
            (err <= atol + rtol * want.abs()).all())
        b_ms, b_by = bound(x, y, got, 2 * m * d1 * d2)
        rec = {"phase": "kernel", "kernel": name, "abft": True,
               "stages": stages, "shape": [m, d1, d2], "dtype": "float32",
               "dispatch_splits": ops.resolve_params(
                   name, m, d1, d2, torch.float32, tsmm.GemmPolicy(),
                   device=dev)["splits"],
               "kernel_ms": time_ms(lambda: kern(x, y)),
               "plain_ms": time_ms(lambda: plain(x, y)),
               "library_ms": time_ms(lambda: library(x, y)),
               "device_ms": device_ms(lambda: kern(x, y), name),
               "call_device_ms": call_device_ms(lambda: kern(x, y)),
               # the op as the guard dispatches it ("auto": the split
               # kernel and its sum where the chooser splits)
               "dispatch_device_ms": call_device_ms(lambda: op(x, y)),
               "library_device_ms": call_device_ms(lambda: library(x, y)),
               "bound_ms": b_ms, "bound_by": b_by,
               "max_err": float(err.max()), "rtol": rtol, "atol": atol,
               "ok": ok, "gpu": gpu}
        if name == "tsm2r":
            rec["body"], rec["grid"] = k_tsm2r.plan(x, y)
        if rec["dispatch_splits"] > 1:
            # The path runs the split kernel there, at the S and block the
            # dispatcher resolves: the partials against their plain
            # version and the op as dispatched (split kernel and sum)
            # against the product's, each with a bit-identical repeat,
            # then the split kernel's own device time.
            mm = entry == "mm"
            S, blk = rec["dispatch_splits"], ops.resolve_params(
                name, m, d1, d2, torch.float32, tsmm.GemmPolicy(),
                device=dev)["block_k" if mm else "block_m"]
            split = k_tsm2r.tsm2r_split if mm else k_tsmt.tsmt_split
            split_plain = ref.tsm2r_split_ref if mm else ref.tsmt_split_ref
            part, part2 = split(x, y, S, blk), split(x, y, S, blk)
            dop, dop2 = op(x, y), op(x, y)
            torch.cuda.synchronize()
            want_part = split_plain(x, y, S, blk)
            p_atol = TOL[torch.float32][1] * max(
                1.0, (ref.split_len(depth, S, blk) / 1024) ** 0.5)
            p_err = (part - want_part).abs()
            d_err = (dop - want).abs()
            split_ok = (torch.equal(part, part2) and torch.equal(dop, dop2)
                        and bool((p_err <= p_atol
                                  + rtol * want_part.abs()).all())
                        and bool((d_err <= atol + rtol * want.abs()).all()))
            rec.update({
                "split_kernel": f"{name}_split", "split_block": blk,
                "split_max_err": float(p_err.max()), "split_atol": p_atol,
                "dispatch_max_err": float(d_err.max()),
                "split_ok": split_ok,
                "split_ms": time_ms(lambda: split(x, y, S, blk)),
                "split_device_ms": device_ms(lambda: split(x, y, S, blk),
                                             f"{name}_split")})
            rec["ok"] = ok = ok and split_ok
            del part, part2, dop, dop2, want_part, p_err, d_err
        emit(rec)
        if not ok:
            bad.append(f"{name} {m}x{d1}x{d2}")
        rows.setdefault(name, []).append(rec)
        del x, y, got, again, want, err
    torch.cuda.empty_cache()
    check(not bad, f"kernel mismatch at the ABFT shapes: {bad}")
    return rows


def tsm2l_sweep(dev, uniform, gpu) -> float:
    """The paper's TSM2L at [10^7,16,16] f32: the tile body and the stream
    body at each rows-a-thread variant (the paper's Fig. 5 tcf sweep), on
    the device in one profiler session; then bf16 at 4 and 2 rows a thread
    at [10^7,16,16] and [2^20,16,16]. Each within tolerance of the plain
    version. Returns the tile body's device ms."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import _build, ref

    m, k, n = 10 ** 7, 16, 16
    a, b = uniform((m, k), torch.float32), uniform((k, n), torch.float32)
    want = ref.tsm2l_ref(a, b)
    outs = []
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(variant):
        out = torch.empty((m, n), device=dev)
        outs.append(out)
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, stream)

        def run():
            err = (_build.tsm2l_tile_launch(*args) if variant is None
                   else _build.tsm2l_variant_launch("f32", variant, *args))
            check(err == 0, f"tsm2l sweep rows {variant}: error {err}")
        return run

    rows = _build.tsm2l_sweep_variants()
    fns = [launcher(None)] + [launcher(r) for r in rows]
    times = device_ms_each(fns, "tsm2l")
    torch.cuda.synchronize()
    rtol, atol = TOL[torch.float32]
    oks = [bool(((o - want).abs() <= atol + rtol * want.abs()).all())
           for o in outs]
    b_ms, _ = bound(a, b, want, 2 * m * k * n)
    geos = [perf_model.tsm2l_stream_geometry(k, n, torch.float32, rows=r)
            for r in rows]
    del a, b, want, outs
    # bf16 (32-byte rows: 4 rows a thread by default) at 4 and 2 rows a
    # thread, at both paper shapes.
    bf16_arms = []
    for mb in (m, 1 << 20):
        a, b = (uniform((mb, k), torch.bfloat16),
                uniform((k, n), torch.bfloat16))
        want = ref.tsm2l_ref(a, b)
        arms = []
        for r in (4, 2):
            out = torch.empty((mb, n), dtype=torch.bfloat16, device=dev)
            args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), mb, k, n,
                    stream)

            def run(r=r, args=args):
                err = _build.tsm2l_variant_launch("bf16", r, *args)
                check(err == 0, f"tsm2l bf16 rows {r}: error {err}")
            arms.append((r, run, out))
        times_b = device_ms_each([arm[1] for arm in arms], "tsm2l")
        torch.cuda.synchronize()
        rb, ab = TOL[torch.bfloat16]
        for (r, _, o), t in zip(arms, times_b):
            bf16_arms.append({
                "m": mb, "rows": r, "device_ms": t,
                "ok": bool(((o.float() - want.float()).abs()
                            <= ab + rb * want.float().abs()).all())})
        del a, b, want, arms
    emit({"phase": "tsm2l_sweep", "shape": [m, k, n], "dtype": "float32",
          "tile_device_ms": times[0], "tile_ok": oks[0],
          "variants": [{"rows": r, "groups": g["groups"],
                        "block_m": g["block_m"], "stages": g["stages"],
                        "device_ms": t, "ok": ok, "default": i == 0}
                       for i, (r, g, t, ok) in enumerate(
                           zip(rows, geos, times[1:], oks[1:]))],
          "bound_ms": b_ms, "bf16": bf16_arms, "gpu": gpu})
    check(all(oks) and all(r["ok"] for r in bf16_arms),
          f"tsm2l sweep mismatch: {oks} {bf16_arms}")
    torch.cuda.empty_cache()
    return times[0]


def widening_cost(uniform, gpu) -> None:
    """What widening costs: each op of ``WIDENED_OPS`` through ``tsmm`` /
    ``tsmm_t`` on a bfloat16·float32 pair and a float16 pair (both widened
    to f32 before the kernel) beside the same op on a bfloat16 pair, each
    call's device time (every kernel it runs, the widening copies too)."""
    from repro_torch.core import tsmm

    times = []
    for kind, entry, sa, sb in WIDENED_OPS:
        op = tsmm.tsmm if entry == "mm" else tsmm.tsmm_t
        for da, db in ((torch.bfloat16, torch.bfloat16),
                       (torch.bfloat16, torch.float32),
                       (torch.float16, torch.float16)):
            x, y = uniform(sa, da), uniform(sb, db)

            def run(op=op, x=x, y=y):
                with tsmm.policy(split="never"):
                    return op(x, y)
            times.append({"kind": kind, "dtypes": [str(da)[6:], str(db)[6:]],
                          "op_device_ms": call_device_ms(run)})
            del x, y
    emit({"phase": "kernel", "op": "widening", "ops": times, "gpu": gpu})


def tsmt_plan_check(x, y, got, dtype, q=None) -> dict:
    """The sequential TSMT (``q``: tsmt_q8's scales) against its split
    kernel at the plan's S: the split partials summed in slice order must
    equal the kernel's output bit for bit."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import tsmt as k_tsmt

    (m, a), b = x.shape, y.shape[1]
    band = perf_model.Q8_BAND
    if q is None:
        S, slice_ = k_tsmt._plan(m, a, b, x.device, dtype)
        parts = k_tsmt.tsmt_split(x, y, S, perf_model.TSMT_BLOCK_M)
    else:
        S, slice_ = k_tsmt._plan(m, a, b, x.device, torch.int8, band)
        parts = k_tsmt.tsmt_q8_split(x, y, *q, band, S)
    return {"plan_splits": S, "plan_slice": slice_,
            "bits_vs_split_sum": same_bits(got, in_slice_order(parts,
                                                               dtype))}


def tsmt_sweep(dev, uniform, gpu) -> None:
    """Device time of tsmt and tsmt_q8 at S slices other than the plan's,
    where ``perf_model``'s two constants were read from: at
    [65536,128]^T [65536,4] over the slice length, at [2^20,128]^T
    [2^20,4] over 1, 2 and 4 blocks per SM. Launches go straight through
    the C launchers, so the wrappers' counts do not move."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import _launch, quant, ref
    from repro_torch.kernels import tsmt as k_tsmt

    band, n_sms = perf_model.Q8_BAND, torch.cuda.get_device_properties(
        dev).multi_processor_count
    for m, Ss in [(65536, (16, 32, 64, 128, 256)),
                  (1 << 20, (n_sms, 2 * n_sms, 4 * n_sms))]:
        x, y = uniform((m, 128), torch.float32), uniform((m, 4),
                                                         torch.float32)
        xq, xs = quant.quantize_blocks(x, band)
        yq, ys = quant.quantize_blocks(y, band)
        for name, quantum in (("tsmt", perf_model.TSMT_BLOCK_M),
                              ("tsmt_q8", band)):
            plans = []
            for S in Ss:
                slice_ = ref.split_len(m, S, quantum)
                S = -(-m // slice_)
                plans.append((S, ref.split_len(m, S, quantum)))

            def at(S, slice_, name=name):
                out = torch.empty((128, 4), device=dev)
                ws = k_tsmt._workspace(S, 128, 4, dev)
                if name == "tsmt":
                    _launch.launch(name, torch.float32, x, y, out, m, 128, 4,
                                   S, slice_, ws)
                else:
                    _launch.launch(name, torch.float32, xq, yq, xs, ys, out,
                                   m, 128, 4, band, S, slice_, ws)
            ms = device_ms_each([lambda p=p: at(*p) for p in plans], name)
            dtype, q_band = ((torch.int8, band) if name == "tsmt_q8"
                             else (torch.float32, None))
            emit({"phase": "tsmt_sweep", "kernel": name, "shape": [m, 128, 4],
                  "splits": [p[0] for p in plans],
                  "slice_rows": [p[1] for p in plans], "device_ms": ms,
                  "plan": k_tsmt._plan(m, 128, 4, dev, dtype, q_band),
                  "gpu": gpu})
        del x, y, xq, yq, xs, ys
        torch.cuda.empty_cache()


def probe_misses(got, a, sel) -> tuple[int, list]:
    """How many cells of a layout probe's output ``got`` differ from A's
    selected columns ``a[:, sel]``, and the first eight, each with the rows
    of its wanted column and the columns of its wanted row that hold the
    value it got: a swapped row or column shows there."""
    want = a[:, sel].float()
    got = got.float()
    wrong = (got != want).nonzero().tolist()
    return len(wrong), [
        {"cell": [r, c], "got": float(got[r, c]),
         "rows_holding_it": (want[:, c] == got[r, c]).nonzero().flatten()[
             :4].tolist(),
         "cols_holding_it": (want[r] == got[r, c]).nonzero().flatten()[
             :4].tolist()} for r, c in wrong[:8]]


def tsm2r_probes(dev, uniform, gpu) -> None:
    """Two tsm2r cases beside the shape sweep, bf16, each with a
    bit-identical repeat. A layout probe on the wgmma body: A of small
    integers, B a column-selection matrix (column j picks row sel(j) of
    B), so C[i, j] = A[i, sel(j)] exactly; a wrong accumulator map or
    shared-memory descriptor shows as wrong cells, reported with the rows
    and columns whose values they hold. Then a base address off the
    16-byte grid, which TMA cannot take: the simt body, against the plain
    version at bf16's tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tsm2r as k_tsm2r

    m, k, n = 1000, 1024, 256
    rows = torch.arange(m, device=dev)[:, None]
    a = ((rows * 13 + torch.arange(k, device=dev) * 5) % 255 - 127).to(
        torch.bfloat16)                   # integers in [-127, 127]: exact
    sel = (torch.arange(n, device=dev) * 7 + 3) % k
    b = torch.zeros((k, n), dtype=torch.bfloat16, device=dev)
    b[sel, torch.arange(n, device=dev)] = 1
    got, again = k_tsm2r.tsm2r(a, b), k_tsm2r.tsm2r(a, b)
    torch.cuda.synchronize()
    wrong, swapped = probe_misses(got, a, sel)
    body = k_tsm2r.plan(a, b)[0]
    ok = body == "wgmma" and not wrong and torch.equal(got, again)
    emit({"phase": "kernel", "kernel": "tsm2r", "case": "layout_probe",
          "shape": [m, k, n], "dtype": "bfloat16", "body": body,
          "wrong_cells": wrong, "first_wrong": swapped,
          "deterministic": torch.equal(got, again), "ok": ok, "gpu": gpu})
    check(ok, f"tsm2r layout probe: body {body}, {wrong} wrong cells "
          f"{swapped}")

    m, k, n = 1024, 1024, 256
    flat = uniform((m * k + 1,), torch.bfloat16)
    a = flat[1:].view(m, k)               # 2 bytes past a 16-byte boundary
    b = uniform((k, n), torch.bfloat16)
    got, again = k_tsm2r.tsm2r(a, b), k_tsm2r.tsm2r(a, b)
    torch.cuda.synchronize()
    want = ref.tsm2r_ref(a, b)
    rtol, atol = TOL[torch.bfloat16]
    err = (got.float() - want.float()).abs()
    body = k_tsm2r.plan(a, b)[0]
    ok = (body == "simt" and torch.equal(got, again)
          and bool((err <= atol + rtol * want.float().abs()).all()))
    emit({"phase": "kernel", "kernel": "tsm2r", "case": "unaligned_base",
          "shape": [m, k, n], "dtype": "bfloat16", "body": body,
          "a_ptr_mod_16": a.data_ptr() % 16, "max_err": float(err.max()),
          "rtol": rtol, "atol": atol,
          "deterministic": torch.equal(got, again), "ok": ok, "gpu": gpu})
    check(ok, f"tsm2r at a misaligned base: body {body}, "
          f"{float(err.max())}")


def skinny_probes(dev, gpu) -> None:
    """Exact layout probes of tsm2r's skinny body at n = 16 and n = 4, f32
    and bf16: A of small integers, B a column selection (column j picks k
    row sel(j)), so C[i, j] = A[i, sel(j)] exactly, through tsm2r and
    through tsm2r_split at S = 3, whose partials summed are exact too (one
    slice holds row sel(j), the others add zeros); each with a
    bit-identical repeat. m = 1000 leaves a ragged row tile, k = 1000 a
    part box at the end, and the 352-deep slices start bf16's second and
    third slices in the middle of a 64-deep box."""
    from repro_torch.kernels import tsm2r as k_tsm2r

    m = k = 1000
    rows = torch.arange(m, device=dev)[:, None]
    for n in (16, 4):
        cols = torch.arange(n, device=dev)
        sel = (cols * (k // n + 7) + 3) % k      # spread over the slices
        for dtype in (torch.float32, torch.bfloat16):
            a = ((rows * 13 + torch.arange(k, device=dev) * 5) % 255
                 - 127).to(dtype)                 # integers: exact
            b = torch.zeros((k, n), dtype=dtype, device=dev)
            b[sel, cols] = 1
            got, again = k_tsm2r.tsm2r(a, b), k_tsm2r.tsm2r(a, b)
            parts = k_tsm2r.tsm2r_split(a, b, 3, 32)
            parts2 = k_tsm2r.tsm2r_split(a, b, 3, 32)
            torch.cuda.synchronize()
            wrong, first = probe_misses(got, a, sel)
            wrong_s, first_s = probe_misses(parts.sum(0), a, sel)
            bodies = [k_tsm2r.plan(a, b)[0],
                      k_tsm2r.split_plan(a, b, 3, 32)[0]]
            same = torch.equal(got, again) and torch.equal(parts, parts2)
            ok = (bodies == ["skinny", "skinny"] and not wrong
                  and not wrong_s and same)
            emit({"phase": "kernel", "kernel": "tsm2r", "case": "layout_probe",
                  "shape": [m, k, n], "dtype": str(dtype)[6:],
                  "body": bodies[0], "split_body": bodies[1], "splits": 3,
                  "wrong_cells": wrong, "first_wrong": first,
                  "split_wrong_cells": wrong_s, "split_first_wrong": first_s,
                  "deterministic": same, "ok": ok, "gpu": gpu})
            check(ok, f"skinny layout probe n={n} {dtype}: bodies {bodies}, "
                  f"{wrong} / {wrong_s} wrong cells {first} {first_s}")


def skinny_sweep(dev, uniform, gpu) -> None:
    """Device time of the skinny body's variants (rows a thread, k-splitting
    groups, stages, producer warps; ``_build.sweep_variants``, the first
    the default) at tsm2r_split f32's main-path shape
    [16384,16384]·[16384,16], S = 2, and at PowerSGD's P
    [65024,4096]·[4096,4], S = 1, beside the bytes bound and one
    ``torch.matmul``'s device time; each variant is held against the
    plain version at the f32 tolerance. Then the int8 stage's variants
    through tsm2r_q8_split's launcher at P (S = 1, what tsm2r_q8 runs
    there) and at tsm2r_q8_split's main-path shape
    [4096,65536]·[65536,16], S = 4, each bit-equal to the plain version
    (every slice is under 131,072 deep), beside the library call of the
    dequantized operands. Launches go straight through the C launchers,
    so the wrappers' counts do not move."""
    from repro_torch.kernels import _build, quant, ref

    variants = _build.sweep_variants()
    for m, k, n, S in [(16384, 16384, 16, 2), (65024, 4096, 4, 1)]:
        x, y = uniform((m, k), torch.float32), uniform((k, n), torch.float32)
        slice_ = ref.split_len(k, S, 32)
        out = torch.empty((S, m, n), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def at(i):
            err = _build.sweep_launch(i, x.data_ptr(), y.data_ptr(),
                                      out.data_ptr(), m, k, n, S, slice_,
                                      stream)
            check(err == 0, f"skinny sweep variant {variants[i]}: "
                  f"cudaError_t {err}")

        want = ref.tsm2r_split_ref(x, y, S, 32)
        rtol, atol = TOL[torch.float32]
        atol *= max(1.0, (slice_ / 1024) ** 0.5)
        errs, oks = [], []
        for i in range(len(variants)):
            out.fill_(float("nan"))         # every output must be written
            at(i)
            torch.cuda.synchronize()
            err = (out - want).abs()
            errs.append(float(err.max()))
            oks.append(bool((err <= atol + rtol * want.abs()).all()))
        ms = device_ms_each([lambda i=i: at(i) for i in range(len(variants))],
                            "tsm2r_split")
        b_ms, b_by = bound(x, y, out, 2 * m * k * n)
        emit({"phase": "skinny_sweep", "shape": [m, k, n], "splits": S,
              "dtype": "float32", "variants": [
                  {"rows_a_thread": r, "groups": g, "stages": st,
                   "producers": pw, "device_ms": t, "max_err": e, "ok": ok}
                  for (r, g, st, pw), t, e, ok in zip(variants, ms, errs,
                                                      oks)],
              "bound_ms": b_ms, "bound_by": b_by,
              "library_device_ms": call_device_ms(lambda: torch.matmul(x,
                                                                       y)),
              "gpu": gpu})
        check(all(oks), f"skinny sweep at {m, k, n}: errors {errs}")
        del x, y, out, want
        torch.cuda.empty_cache()

    band = 256
    for m, k, n, S in [(65024, 4096, 4, 1), (4096, 65536, 16, 4)]:
        xq, xs = quant.quantize_blocks(uniform((m, k), torch.float32), band)
        yq, ys = quant.quantize_tensor(uniform((k, n), torch.float32))
        slice_ = ref.split_len(k, S, 32)
        out = torch.empty((S, m, n), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def at(i):
            err = _build.sweep_launch_q8(
                i, xq.data_ptr(), yq.data_ptr(), xs.data_ptr(),
                ys.data_ptr(), out.data_ptr(), m, k, n, band, S, slice_,
                stream)
            check(err == 0, f"int8 skinny sweep variant {variants[i]}: "
                  f"cudaError_t {err}")

        want = ref.tsm2r_q8_split_ref(xq, yq, xs, ys, band, S, 32)
        oks = []
        for i in range(len(variants)):
            out.fill_(float("nan"))         # every output must be written
            at(i)
            torch.cuda.synchronize()
            oks.append(same_bits(out, want))
        ms = device_ms_each([lambda i=i: at(i) for i in range(len(variants))],
                            "tsm2r_q8_split")
        b_ms, b_by = bound(xq, yq, out, 2 * m * k * n, xs, ys)
        xd = quant.dequantize_blocks(xq, xs, torch.float32, block_rows=band)
        yd = quant.dequantize_blocks(yq, ys, torch.float32)
        emit({"phase": "skinny_sweep", "shape": [m, k, n], "splits": S,
              "dtype": "int8", "variants": [
                  {"rows_a_thread": r, "groups": g, "stages": st,
                   "producers": pw, "device_ms": t, "bits_vs_plain": ok}
                  for (r, g, st, pw), t, ok in zip(variants, ms, oks)],
              "bound_ms": b_ms, "bound_by": b_by,
              "library_device_ms": call_device_ms(lambda: torch.matmul(xd,
                                                                       yd)),
              "gpu": gpu})
        check(all(oks), f"int8 skinny sweep at {m, k, n}: bits {oks}")
        del xq, xs, yq, ys, out, want, xd, yd
        torch.cuda.empty_cache()


def tsm2r_q8_probes(dev, uniform, gpu) -> None:
    """tsm2r_q8 beside its case sweep. A layout probe on the wgmma body:
    A of int8 codes in [-127, 127], B a column selection (column j picks k
    row sel(j)) given K-major, both scales 1, so C[i, j] = A[i, sel(j)]
    exactly; wrong cells are reported with the rows and columns whose
    values they hold. Then B row-major at the ragged and the serving
    shapes: the wrapper copies it K-major with its transpose kernel (one
    count a call), and the result must equal the K-major call's bits; the
    copy's device time beside its bytes bound."""
    from repro_torch.kernels import quant
    from repro_torch.kernels import tsm2r as k_tsm2r

    m, k, n = 1000, 1024, 256
    rows = torch.arange(m, device=dev)[:, None]
    a = ((rows * 13 + torch.arange(k, device=dev) * 5) % 255 - 127).to(
        torch.int8)
    sel = (torch.arange(n, device=dev) * 7 + 3) % k
    bt = torch.zeros((n, k), dtype=torch.int8, device=dev)
    bt[torch.arange(n, device=dev), sel] = 1
    b = bt.t()                                  # K-major [k, n]
    ones = torch.ones(-(-m // 256), device=dev)
    got = k_tsm2r.tsm2r_q8(a, b, ones, ones[:1], 256, torch.float32)
    again = k_tsm2r.tsm2r_q8(a, b, ones, ones[:1], 256, torch.float32)
    torch.cuda.synchronize()
    wrong, swapped = probe_misses(got, a, sel)
    body = k_tsm2r.q8_plan(a, b)[0]
    ok = body == "wgmma" and not wrong and torch.equal(got, again)
    emit({"phase": "kernel", "kernel": "tsm2r_q8", "case": "layout_probe",
          "shape": [m, k, n], "dtype": "float32", "body": body,
          "wrong_cells": wrong, "first_wrong": swapped,
          "deterministic": torch.equal(got, again), "ok": ok, "gpu": gpu})
    check(ok, f"tsm2r_q8 layout probe: body {body}, {wrong} wrong cells "
          f"{swapped}")

    band = 256
    for m, k, n in [(1000, 784, 200), (8192, 4096, 256)]:
        xq, xs = quant.quantize_blocks(uniform((m, k), torch.float32), band)
        y = uniform((k, n), torch.float32)
        yk, ys = quant.quantize_tensor(y, kmajor=True)
        yr, _ = quant.quantize_tensor(y)
        before = k_tsm2r.q8_transpose_launches
        got_r = k_tsm2r.tsm2r_q8(xq, yr, xs, ys, band, torch.bfloat16)
        copies = k_tsm2r.q8_transpose_launches - before
        got_k = k_tsm2r.tsm2r_q8(xq, yk, xs, ys, band, torch.bfloat16)
        torch.cuda.synchronize()
        back = k_tsm2r.q8_transpose(yk)
        torch.cuda.synchronize()
        ok = (copies == 1 and same_bits(got_r, got_k)
              and back.is_contiguous() and torch.equal(back, yr))
        emit({"phase": "kernel", "kernel": "tsm2r_q8_transpose",
              "shape": [k, n], "for_tsm2r_q8": [m, k, n],
              "body": k_tsm2r.q8_plan(xq, yr)[0], "copies_per_call": copies,
              "bits_row_major_vs_kmajor_b": same_bits(got_r, got_k),
              "device_ms": device_ms(lambda: k_tsm2r.q8_transpose(yr),
                                     "tsm2r_q8_transpose"),
              "kernel_ms": time_ms(lambda: k_tsm2r.q8_transpose(yr)),
              "library_ms": time_ms(lambda: yr.t().contiguous()),
              "bound_ms": 2 * k * n / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "ok": ok, "gpu": gpu})
        check(ok, f"tsm2r_q8 with a row-major B at {m, k, n}: {copies} "
              f"copies, bits {same_bits(got_r, got_k)}")
        del xq, xs, y, yk, yr, got_r, got_k, back


def q8_skinny_probes(dev, gpu) -> None:
    """Exact layout probes of the int8 skinny body at n = 16 and n = 4: A of
    int8 codes in [-127, 127], B a row-major column selection (column j
    picks k row sel(j)), both scales 1, so C[i, j] = A[i, sel(j)] exactly,
    through tsm2r_q8 and through tsm2r_q8_split at S = 3, whose partials
    summed are exact too (one slice holds row sel(j), the others add
    zeros); each with a bit-identical repeat. m = 1000 leaves a ragged row
    tile, k = 1008 a part box at the end, and the 352-deep slices start in
    the middle of a 128-deep int8 box."""
    from repro_torch.kernels import tsm2r as k_tsm2r

    m, k = 1000, 1008
    rows = torch.arange(m, device=dev)[:, None]
    a = ((rows * 13 + torch.arange(k, device=dev) * 5) % 255 - 127).to(
        torch.int8)
    ones = torch.ones(-(-m // 256), device=dev)
    for n in (16, 4):
        cols = torch.arange(n, device=dev)
        sel = (cols * (k // n + 7) + 3) % k      # spread over the slices
        b = torch.zeros((k, n), dtype=torch.int8, device=dev)
        b[sel, cols] = 1
        q = (a, b, ones, ones[:1], 256)
        got = k_tsm2r.tsm2r_q8(*q, torch.float32)
        again = k_tsm2r.tsm2r_q8(*q, torch.float32)
        parts = k_tsm2r.tsm2r_q8_split(*q, 3, 32)
        parts2 = k_tsm2r.tsm2r_q8_split(*q, 3, 32)
        torch.cuda.synchronize()
        wrong, first = probe_misses(got, a, sel)
        wrong_s, first_s = probe_misses(parts.sum(0), a, sel)
        bodies = [k_tsm2r.q8_plan(a, b)[0],
                  k_tsm2r.q8_split_plan(a, b, 3, 32)[0]]
        same = torch.equal(got, again) and torch.equal(parts, parts2)
        ok = (bodies == ["skinny", "skinny"] and not wrong and not wrong_s
              and same)
        emit({"phase": "kernel", "kernel": "tsm2r_q8", "case": "layout_probe",
              "shape": [m, k, n], "dtype": "float32", "body": bodies[0],
              "split_body": bodies[1], "splits": 3, "wrong_cells": wrong,
              "first_wrong": first, "split_wrong_cells": wrong_s,
              "split_first_wrong": first_s, "deterministic": same, "ok": ok,
              "gpu": gpu})
        check(ok, f"int8 skinny layout probe n={n}: bodies {bodies}, "
              f"{wrong} / {wrong_s} wrong cells {first} {first_s}")


def tsmt_q8_probes(dev, gpu) -> None:
    """Exact layout probes of the packed int8 TSMT body at b = 4 and b =
    16: X of int8 codes in [-127, 127], Y one-hot (Y[r_j, j] = 1), all
    scales 1, so C[:, j] = X[r_j, :] exactly. The rows r_j sit at every
    position within a 4-row packet, in different thread groups of the
    default variant, in different packets of a group and in different
    bands (the last one short: m = 1000); a = 144 leaves a ragged a-tile.
    Through tsmt_q8 (S = 1 at this m) and tsmt_q8_split at S = 3 (whole
    bands: 512, 488 and 0 rows), whose partials summed are exact too;
    each with a bit-identical repeat."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import tsmt as k_tsmt

    m, a, band = 1000, 144, perf_model.Q8_BAND
    rows = torch.arange(m, device=dev)[:, None]
    x = ((rows * 13 + torch.arange(a, device=dev) * 5) % 255 - 127).to(
        torch.int8)
    ones = torch.ones(-(-m // band), device=dev)
    for b in (4, 16):
        ta, tb = perf_model.tsmt_tile(b)
        groups = 256 // ((ta // 8) * (tb // 4))   # 8 bytes, 4 columns a thread
        sel = [band * (j if b == 4 else j // 4)
               + 4 * ((3 * j + 1) % groups + groups * (3 * j % 4)) + j % 4
               for j in range(b)]
        check(len(set(sel)) == b and max(sel) < m, f"probe rows {sel}")
        sel = torch.tensor(sel, device=dev)
        y = torch.zeros((m, b), dtype=torch.int8, device=dev)
        y[sel, torch.arange(b, device=dev)] = 1
        q = (x, y, ones, ones, band)
        got = k_tsmt.tsmt_q8(*q, torch.float32)
        again = k_tsmt.tsmt_q8(*q, torch.float32)
        parts = k_tsmt.tsmt_q8_split(*q, 3)
        parts2 = k_tsmt.tsmt_q8_split(*q, 3)
        torch.cuda.synchronize()
        wrong, first = probe_misses(got, x.t(), sel)
        wrong_s, first_s = probe_misses(parts.sum(0), x.t(), sel)
        bodies = [k_tsmt.q8_plan(x, y)[0], k_tsmt.q8_plan(x, y, True)[0]]
        same = torch.equal(got, again) and torch.equal(parts, parts2)
        ok = (bodies == ["packed", "packed"] and not wrong and not wrong_s
              and same)
        emit({"phase": "kernel", "kernel": "tsmt_q8", "case": "layout_probe",
              "shape": [m, a, b], "dtype": "float32", "body": bodies[0],
              "split_body": bodies[1], "splits": 3, "rows": sel.tolist(),
              "wrong_cells": wrong, "first_wrong": first,
              "split_wrong_cells": wrong_s, "split_first_wrong": first_s,
              "deterministic": same, "ok": ok, "gpu": gpu})
        check(ok, f"packed int8 TSMT layout probe b={b}: bodies {bodies}, "
              f"{wrong} / {wrong_s} wrong cells {first} {first_s}")


def tsmt_q8_sweep(dev, uniform, gpu) -> None:
    """Device time of the packed int8 TSMT body's variants (bytes of a row
    of X a thread, rows loaded before any is multiplied;
    ``_build.tsmt_q8_sweep_variants``, the first the default; their
    registers are on the resources line) at
    PowerSGD's Q [65024,4096]^T [65024,4], S = 8, beside the bytes bound
    and the library call of the dequantized operands; each variant held
    against the plain version at the f32 tolerance. Launches go straight
    through the C launcher, so the wrappers' counts do not move."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import _build, quant, ref

    band, (m, a, b, S) = perf_model.Q8_BAND, (65024, 4096, 4, 8)
    variants = _build.tsmt_q8_sweep_variants()
    xq, xs = quant.quantize_blocks(uniform((m, a), torch.float32), band)
    yq, ys = quant.quantize_blocks(uniform((m, b), torch.float32), band)
    slice_ = ref.split_len(m, S, band)
    out = torch.empty((S, a, b), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def at(i):
        err = _build.tsmt_q8_sweep_launch(
            i, xq.data_ptr(), yq.data_ptr(), xs.data_ptr(), ys.data_ptr(),
            out.data_ptr(), m, a, b, band, S, slice_, stream)
        check(err == 0, f"tsmt_q8 sweep variant {variants[i]}: cudaError_t "
              f"{err}")

    want = ref.tsmt_q8_split_ref(xq, yq, xs, ys, band, S)
    rtol, atol = TOL[torch.float32]
    atol *= max(1.0, (slice_ / 1024) ** 0.5)
    errs, oks = [], []
    for i in range(len(variants)):
        out.fill_(float("nan"))         # every output must be written
        at(i)
        torch.cuda.synchronize()
        err = (out - want).abs()
        errs.append(float(err.max()))
        oks.append(bool((err <= atol + rtol * want.abs()).all()))
    ms = device_ms_each([lambda i=i: at(i) for i in range(len(variants))],
                        "tsmt_q8_split")
    b_ms, b_by = bound(xq, yq, out, 2 * m * a * b, xs, ys)
    xd = quant.dequantize_blocks(xq, xs, torch.float32, block_rows=band)
    yd = quant.dequantize_blocks(yq, ys, torch.float32, block_rows=band)
    emit({"phase": "tsmt_q8_sweep", "shape": [m, a, b], "splits": S,
          "variants": [{"bytes_a_thread": aw, "rows_in_flight": ru,
                        "device_ms": t, "max_err": e, "ok": ok}
                       for (aw, ru), t, e, ok in zip(variants, ms, errs,
                                                     oks)],
          "bound_ms": b_ms, "bound_by": b_by,
          "library_device_ms": call_device_ms(
              lambda: torch.matmul(xd.t(), yd)),
          "gpu": gpu})
    check(all(oks), f"tsmt_q8 sweep: errors {errs}")
    del xq, xs, yq, ys, out, want, xd, yd
    torch.cuda.empty_cache()


def reduce_sweep(dev, uniform, gpu) -> None:
    """sum_partials on the device at ``REDUCE_SWEEP``'s stacks: the plan's
    body, the first body (``reduce_rows_<tag>``: block_r rows of all cols
    a block) and ``torch.sum(p, dim=0)``, beside the bytes bound and the
    plan; then the body's variants (threads a block, blocks an SM, slices
    a chunk, streaming loads; ``_build.reduce_sweep_variants``, the first
    the plan's) at ``REDUCE_VARIANT_STACKS`` in f32. Every arm must give
    the slice-order sum's bits. Launches go straight through the C
    launchers, so the wrapper's count does not move."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import _build, reduce

    stream = torch.cuda.current_stream(dev).cuda_stream
    spec = perf_model.device_spec(perf_model.H100, dev)
    stacks, bad = [], []

    def arm(launch, p, dtype, outs):
        out = torch.empty(p.shape[1:], dtype=dtype, device=dev)
        outs.append(out)

        def run():
            err = launch(p.data_ptr(), out.data_ptr(), *p.shape, stream)
            check(err == 0, f"reduce sweep {tuple(p.shape)}: error {err}")
        return run

    for shape, dtype in REDUCE_SWEEP:
        tag = "f32" if dtype == torch.float32 else "bf16"
        p = uniform(shape, torch.float32)
        outs = []
        fns = [arm(_build.launcher("reduce", tag), p, dtype, outs),
               arm(lambda *a, t=tag: _build.reduce_rows_launch(t, *a), p,
                   dtype, outs)]
        ms = device_ms_each(fns, "sum_partials")
        torch.cuda.synchronize()
        want = in_slice_order(p, dtype)
        exact = [same_bits(o, want) for o in outs]
        nbytes = p.numel() * 4 + want.numel() * want.element_size()
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        plan = reduce.c_plan(p, outs[0])
        stacks.append({
            "shape": list(shape), "dtype": str(dtype)[6:],
            "device_ms": ms[0], "rows_body_ms": ms[1],
            "library_device_ms": call_device_ms(lambda: torch.sum(p, dim=0)),
            "bound_ms": b_ms, "bound_by": "bytes", "share": b_ms / ms[0],
            "vs_rows_body": ms[0] / ms[1],
            "plan": {"grid": plan[0], "threads": plan[1], "vec": plan[2],
                     "chunk": plan[3]},
            "plan_ok": plan == perf_model.reduce_plan(
                *shape, dtype, p.data_ptr(), outs[0].data_ptr(), spec),
            "bit_equal": exact})
        if not (all(exact) and stacks[-1]["plan_ok"]):
            bad.append(stacks[-1])
        del p, outs, want
    variants = _build.reduce_sweep_variants()
    at = []
    for shape in REDUCE_VARIANT_STACKS:
        p = uniform(shape, torch.float32)
        outs = []
        fns = [arm(lambda *a, i=i: _build.reduce_sweep_launch(i, *a), p,
                   torch.float32, outs) for i in range(len(variants))]
        ms = device_ms_each(fns, "sum_partials")
        torch.cuda.synchronize()
        want = in_slice_order(p, torch.float32)
        exact = [same_bits(o, want) for o in outs]
        at.append({"shape": list(shape), "variants": [
            {"threads": v[0], "blocks_per_sm": v[1], "chunk": v[2],
             "streaming": v[3], "device_ms": t, "bit_equal": e}
            for v, t, e in zip(variants, ms, exact)]})
        if not all(exact):
            bad.append(at[-1])
        del p, outs, want
    torch.cuda.empty_cache()
    emit({"phase": "reduce_sweep", "stacks": stacks, "variants": at,
          "gpu": gpu})
    check(not bad, f"reduce sweep: {bad}")


# The fused quantize pass's cases: (label, shape, dtype, band or None for
# one scale, K-major codes); the first is the serving path's activations.
QUANT_CASES = [
    ("serve-int8 A", (8192, 4096), torch.bfloat16, 256, False),
    ("PowerSGD P operand", (65024, 4096), torch.float32, 256, False),
    ("short last band", (1000, 300), torch.float32, 256, False),
    ("all-zero band", (1024, 64), torch.bfloat16, 256, False),
    ("half-step ties", (512, 8), torch.float32, 8, False),
    ("B per tensor", (4096, 256), torch.bfloat16, None, False),
    ("B per tensor, K-major", (4096, 256), torch.bfloat16, None, True),
]


def quantize_phase(dev, uniform, gpu) -> dict:
    """The fused quantize pass (``csrc/quantize.cu``, behind
    ``quant.quantize_blocks`` / ``quantize_tensor`` for CUDA tensors)
    against the plain code on the same tensor on the card: codes and
    scales bit for bit, K-major codes in their layout. Each line carries
    the pass's device time (both launches and the memset, summed) beside
    its bytes bound (the operand read once, codes and scales written once)
    and the two-pass design's floor (the operand read twice). Returns the
    serving case's record."""
    from repro_torch.kernels import quant

    # Why the plain code divides by a tensor: PyTorch's CUDA division by a
    # Python number multiplies by the rounded reciprocal, which is not
    # the IEEE quotient that JAX (and the CPU) computes.
    a = uniform((1 << 20,), torch.float32).abs() * 50
    emit({"phase": "kernel", "kernel": "quantize",
          "case": "division by a Python number on the card",
          "values": a.numel(), "differ_from_ieee": int(
              (a / 127.0 != a / torch.full_like(a, 127.0)).sum())})
    del a
    measured, bad = None, []
    for label, shape, dtype, band, kmajor in QUANT_CASES:
        x = uniform(shape, dtype)
        if label == "all-zero band":
            x[256:512] = 0
        if label == "half-step ties":
            # absmax 127 in every 8-row band (scale 1): x / scale lands
            # on exact half steps, which round to even.
            x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                              126.5], device=dev).repeat(shape[0] // 8)
            x = x[:, None].expand(shape).contiguous().to(dtype)
        if band is None:
            def fused():
                return quant.quantize_tensor(x, kmajor=kmajor)

            def plain():
                return quant.quantize_tensor_ref(x, kmajor=kmajor)
        else:
            def fused():
                return quant.quantize_blocks(x, band)

            def plain():
                return quant.quantize_blocks_ref(x, band)
        before = quant.launches
        (q, s), (q2, s2) = fused(), fused()
        launched = quant.launches - before
        qr, sr = plain()
        torch.cuda.synchronize()
        same = (torch.equal(q, qr) and torch.equal(s, sr)
                and q.stride() == qr.stride())
        ok = same and launched == 2 and torch.equal(q, q2)
        n_bytes = x.numel() * (x.element_size() + 1) + s.numel() * 4
        rec = {"phase": "kernel", "kernel": "quantize", "case": label,
               "shape": list(shape), "dtype": str(dtype)[6:], "band": band,
               "kmajor": kmajor, "bands": s.numel(),
               "codes_equal": torch.equal(q, qr),
               "scales_equal": torch.equal(s, sr),
               "code_strides": list(q.stride()),
               "max_err": float((q.float() - qr.float()).abs().max()),
               "device_ms": call_device_ms(fused),
               "kernel_ms": time_ms(fused), "plain_ms": time_ms(plain),
               "plain_device_ms": call_device_ms(plain),
               "library_ms": None, "library_device_ms": None,
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "two_pass_bound_ms": (n_bytes + x.numel() * x.element_size())
               / HBM_BYTES_PER_S * 1e3,
               "deterministic": torch.equal(q, q2), "ok": ok, "gpu": gpu}
        emit(rec)
        if measured is None:
            measured = rec
        if not ok:
            bad.append(label)
        del x, q, s, q2, s2, qr, sr
        torch.cuda.empty_cache()
    check(not bad, f"quantize pass differs from the plain code in {bad}")
    return measured


def split_kernel_phase(dev, uniform, gpu) -> dict:
    """Each split kernel and sum_partials against its plain version at the
    main path's, the paper's and the chatglm3 shapes, f32 and bf16, with
    bit-identical repeats. Returns the record of each kernel's main-path
    case."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import ref, reduce
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.kernels import tsmt as k_tsmt

    cases = {   # (m, d1, d2, S); tsm2r (m, k, n), tsmt (m, a, b)
        "tsmt_split": [(65024, 4096, 4, 8), (1 << 20, 128, 4, 32),
                       (65536, 256, 256, 1), (65536, 256, 256, 2),
                       (65536, 256, 256, 16)],
        # the paper's shape at S = 1, 2, 8; slices of 800 k (no multiple
        # of a 64-deep bf16 box); the skinny body's widths 1, 3, 4 and 8;
        # 32-deep slices of k = 104, the last cut at 8 and four empty (a
        # direct call may ask for more slices than k fills); a wide
        # output on the simt body
        "tsm2r_split": [(16384, 16384, 16, 2), (16384, 16384, 16, 1),
                        (16384, 16384, 16, 8), (4096, 4000, 16, 5),
                        (4096, 4096, 1, 2), (4096, 4096, 3, 2),
                        (4096, 4096, 4, 2), (4096, 4096, 8, 2),
                        (1000, 104, 16, 8), (8192, 4096, 256, 4)],
    }
    main_case = {"tsmt_split": ((65024, 4096, 4, 8), torch.float32),
                 "tsm2r_split": ((16384, 16384, 16, 2), torch.float32),
                 "sum_partials": ((2, 16384, 16), torch.float32)}
    measured, bad = {}, []
    for name, shapes in cases.items():
        mm = name == "tsm2r_split"
        kern = k_tsm2r.tsm2r_split if mm else k_tsmt.tsmt_split
        plain = ref.tsm2r_split_ref if mm else ref.tsmt_split_ref
        seq = k_tsm2r.tsm2r if mm else k_tsmt.tsmt
        block = 32 if mm else 8
        for m, d1, d2, S in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x = uniform((m, d1), dtype)
                y = uniform((d1, d2) if mm else (m, d2), dtype)
                got = kern(x, y, S, block)
                again = kern(x, y, S, block)
                torch.cuda.synchronize()
                want = plain(x, y, S, block)
                depth = ref.split_len(d1 if mm else m, S, block)
                # Both sides sum the same products in f32 (the partials
                # are f32 at either input dtype): f32 tolerances.
                rtol, atol = TOL[torch.float32]
                atol *= max(1.0, (depth / 1024) ** 0.5)
                err = (got - want).abs()
                same = torch.equal(got, again)
                ok = same and bool((err <= atol + rtol * want.abs()).all())
                b_ms, b_by = bound(x, y, got, 2 * m * d1 * d2)
                lib = ((lambda: torch.matmul(x, y)) if mm
                       else (lambda: torch.matmul(x.t(), y)))
                rec = {"phase": "kernel", "kernel": name,
                       "shape": [m, d1, d2], "splits": S,
                       "dtype": str(dtype)[6:],
                       "kernel_ms": time_ms(lambda: kern(x, y, S, block)),
                       "op_ms": time_ms(lambda: reduce.reduce_partials(
                           kern(x, y, S, block), dtype)[0]),
                       "seq_ms": time_ms(lambda: seq(x, y)),
                       "plain_ms": time_ms(lambda: plain(x, y, S, block)),
                       "library_ms": time_ms(lib),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "max_err": float(err.max()), "rtol": rtol,
                       "atol": atol, "deterministic": same, "ok": ok,
                       "gpu": gpu}
                if mm:   # the skinny body at n <= 16, else simt
                    rec["body"], rec["grid"] = k_tsm2r.split_plan(x, y, S,
                                                                  block)
                    want_body = "skinny" if d2 <= 16 else "simt"
                    rec["ok"] = ok = ok and rec["body"] == want_body
                is_main = main_case[name] == ((m, d1, d2, S), dtype)
                # tsm2r_split's main case is timed on the device in bf16 too
                if is_main or (mm and main_case[name][0] == (m, d1, d2, S)):
                    rec["device_ms"] = device_ms(
                        lambda: kern(x, y, S, block), name)
                    rec["library_device_ms"] = call_device_ms(lib)
                if is_main:
                    measured[name] = rec
                emit(rec)
                if not ok:
                    bad.append(f"{name} {m}x{d1}x{d2} S={S} {dtype}")
                del x, y, got, again, want, err
                torch.cuda.empty_cache()
    spec = perf_model.device_spec(perf_model.H100, dev)
    for S, rows, cols, off in REDUCE_CASES:
        buf = uniform((S * rows * cols + off,), torch.float32)
        p = buf[off:].view(S, rows, cols)
        for dtype in (torch.float32, torch.bfloat16):
            got = reduce.sum_partials(p, dtype)
            again = reduce.sum_partials(p, dtype)
            torch.cuda.synchronize()
            want = ref.sum_partials_ref(p, dtype)
            plan = reduce.c_plan(p, got)
            mirror = perf_model.reduce_plan(S, rows, cols, dtype,
                                            p.data_ptr(), got.data_ptr(),
                                            spec)
            # Bit for bit: the kernel adds the slices in order from +0.0,
            # as the plain version and in_slice_order do.
            exact = (same_bits(got, in_slice_order(p, dtype))
                     and same_bits(got, want))
            same = same_bits(got, again)
            ok = exact and same and plan == mirror
            nbytes = p.numel() * 4 + got.numel() * got.element_size()
            rec = {"phase": "kernel", "kernel": "sum_partials",
                   "shape": [S, rows, cols], "splits": S,
                   "dtype": str(dtype)[6:],
                   "p_offset_bytes": p.data_ptr() % 16,
                   "plan": {"grid": plan[0], "threads": plan[1],
                            "vec": plan[2], "chunk": plan[3]},
                   "plan_ok": plan == mirror,
                   "kernel_ms": time_ms(lambda: reduce.sum_partials(p,
                                                                    dtype)),
                   "op_ms": None, "seq_ms": None,
                   "plain_ms": time_ms(lambda: ref.sum_partials_ref(p,
                                                                    dtype)),
                   "library_ms": time_ms(lambda: torch.sum(p, dim=0)),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes",
                   "max_err": float((got.float() - want.float()).abs().max()),
                   "bit_equal_slice_order": exact, "deterministic": same,
                   "ok": ok, "gpu": gpu}
            if main_case["sum_partials"] == ((S, rows, cols), dtype) \
                    and off == 0:
                rec["device_ms"] = device_ms(
                    lambda: reduce.sum_partials(p, dtype), "sum_partials")
                rec["library_device_ms"] = call_device_ms(
                    lambda: torch.sum(p, dim=0))
                measured["sum_partials"] = rec
            emit(rec)
            if not ok:
                bad.append(f"sum_partials {S}x{rows}x{cols}+{off} {dtype}")
        del buf, p, got, again, want
    check(not bad, f"split kernel phase mismatch in {bad}")
    rec = measured["tsm2r_split"]
    check(rec["body"] == "skinny" and rec["device_ms"] <= SKINNY_MAX_MS,
          f"tsm2r_split at {rec['shape']}: body {rec['body']}, "
          f"{rec['device_ms']} ms on the device (limit {SKINNY_MAX_MS})")
    rec = measured["sum_partials"]
    check(rec["device_ms"] <= REDUCE_MAX_MS,
          f"sum_partials at {rec['shape']}: {rec['device_ms']} ms on the "
          f"device (limit {REDUCE_MAX_MS})")
    return measured


def q8_kernel_phase(dev, uniform, gpu) -> tuple[dict, dict, dict]:
    """Each int8 kernel against its plain version on the same int8
    operands and scales, with f32 and bf16 outputs, bit-identical
    repeats; timed at its main-path shapes. Then the whole ``tsmm`` /
    ``tsmm_t`` op under ``quant="int8"`` against the f32 product. Returns
    the records of each kernel's main-path case, of its training-path
    cases and of its paper-shape cases (tsm2l_q8)."""
    from repro_torch.core import perf_model, tsmm
    from repro_torch.kernels import quant, ref
    from repro_torch.kernels import tsm2l as k_tsm2l
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.kernels import tsmt as k_tsmt

    band, bk = perf_model.Q8_BAND, perf_model.TSM2R_BLOCK_K
    f32, bf16 = torch.float32, torch.bfloat16
    # name: (entry, kernel(q, dtype, S), plain(q, dtype, S), split?)
    kernels = {
        "tsm2r_q8": ("mm", lambda q, dt, S: k_tsm2r.tsm2r_q8(*q, band, dt),
                     lambda q, dt, S: ref.tsm2r_q8_ref(*q, band, dt), False),
        "tsm2r_q8_split": (
            "mm", lambda q, dt, S: k_tsm2r.tsm2r_q8_split(*q, band, S, bk),
            lambda q, dt, S: ref.tsm2r_q8_split_ref(*q, band, S, bk), True),
        "tsm2l_q8": ("mm", lambda q, dt, S: k_tsm2l.tsm2l_q8(*q, band, dt),
                     lambda q, dt, S: ref.tsm2l_q8_ref(*q, band, dt), False),
        "tsmt_q8": ("mmt", lambda q, dt, S: k_tsmt.tsmt_q8(*q, band, dt),
                    lambda q, dt, S: ref.tsmt_q8_ref(*q, band, dt), False),
        "tsmt_q8_split": (
            "mmt", lambda q, dt, S: k_tsmt.tsmt_q8_split(*q, band, S),
            lambda q, dt, S: ref.tsmt_q8_split_ref(*q, band, S), True),
    }
    # (m, d1, d2, S, deep, timed as): the main-path shapes first; "deep"
    # reductions are of one sign with codes near 127, so a single int32
    # sum over their depth (> 133,143 terms) would overflow. tsm2r_q8 adds
    # the skinny body's widths 1, 3 and 8, tsm2r_q8_split 800-deep slices
    # that start in the middle of a 128-deep int8 box.
    cases = {
        "tsm2r_q8": [(8192, 4096, 256, 1, False, "main"),
                     (4096, 4096, 256, 1, False, "train"),
                     (65024, 4096, 4, 1, False, "train"),
                     (1000, 784, 200, 1, False, None),
                     (1000, 777, 17, 1, False, None),
                     (4096, 4096, 1, 1, False, None),
                     (4096, 4096, 3, 1, False, None),
                     (4096, 4096, 8, 1, False, None),
                     (256, 270000, 32, 1, True, None),
                     (512, 300000, 4, 1, True, None)],
        "tsm2r_q8_split": [(4096, 65536, 16, 4, False, "main"),
                           (16384, 16384, 16, 2, False, None),
                           (4096, 4000, 16, 5, False, None),
                           (1000, 777, 17, 3, False, None),
                           (512, 300000, 4, 2, True, None)],
        "tsm2l_q8": [(102400, 4, 4, 1, False, "main"),
                     (1 << 20, 16, 16, 1, False, "paper"),
                     (10 ** 7, 16, 16, 1, False, "paper"),
                     (10000, 300, 20, 1, False, None),
                     (512, 200000, 4, 1, True, None),
                     (333, 1, 16, 1, False, None),
                     (1003, 129, 16, 1, False, None),
                     (4096, 255, 9, 1, False, None)],
        "tsmt_q8": [(65536, 128, 4, 1, False, "main"),
                    (65024, 4096, 4, 1, False, "train"),   # PowerSGD's Q
                    (10000, 300, 20, 1, False, None),
                    (300000, 16, 4, 1, True, None),
                    (1000, 100, 3, 1, False, None)],    # plans S = 1
        "tsmt_q8_split": [(65024, 4096, 4, 8, False, "main"),
                          (1 << 20, 128, 4, 32, False, None),
                          (10000, 300, 20, 3, False, None),
                          (300000, 16, 4, 2, True, None)],
    }
    main_dtype = {"tsm2r_q8": bf16}
    measured, at_train, at_paper, bad = {}, {}, {}, []
    for name, (entry, kern, plain, split) in kernels.items():
        for m, d1, d2, S, deep, timed in cases[name]:
            x = uniform((m, d1), f32)
            y = uniform((d1, d2) if entry == "mm" else (m, d2), f32)
            if deep:
                x, y = x.abs() * 0.5 + 0.5, y.abs() * 0.5 + 0.5
            xq, xs = quant.quantize_blocks(x, band)
            # tsm2r_q8's B K-major where its wgmma body runs, as ops.py
            # quantizes it.
            kmajor = (name == "tsm2r_q8" and perf_model.tsm2r_body(
                d1, d2, torch.int8) == "wgmma")
            yq, ys = (quant.quantize_tensor(y, kmajor=kmajor)
                      if entry == "mm" else quant.quantize_blocks(y, band))
            q = (xq, yq, xs, ys)
            depth = d1 if entry == "mm" else m
            if split:
                depth = ref.split_len(depth, S, bk if entry == "mm" else band)
            for dtype in ((f32,) if split else (f32, bf16)):
                got = kern(q, dtype, S)
                again = kern(q, dtype, S)
                torch.cuda.synchronize()
                want = plain(q, dtype, S)
                rtol, atol = TOL[dtype]
                if dtype == f32:
                    atol *= max(1.0, (depth / 1024) ** 0.5)
                err = (got.float() - want.float()).abs()
                same = torch.equal(got, again)
                ok = same and bool(
                    (err <= atol + rtol * want.float().abs()).all())
                rec = {"phase": "kernel", "kernel": name,
                       "shape": [m, d1, d2], "splits": S, "deep": deep,
                       "dtype": str(dtype)[6:], "max_err": float(err.max()),
                       "rtol": rtol, "atol": atol, "deterministic": same,
                       "ok": ok, "gpu": gpu}
                if name == "tsmt_q8":
                    rec.update(tsmt_plan_check(xq, yq, got, dtype, (xs, ys)))
                    rec["ok"] = ok = ok and rec["bits_vs_split_sum"]
                if name in ("tsmt_q8", "tsmt_q8_split"):
                    # The library's body, its Python mirror's, and the
                    # body this case must take.
                    rec["body"], rec["grid"] = k_tsmt.q8_plan(xq, yq, split)
                    mirror = perf_model.tsmt_q8_plan(
                        m, d1, d2, xq.data_ptr(), yq.data_ptr())
                    want_body = ("packed" if (m, d1, d2) in TSMT_Q8_PACKED
                                 else "simt")
                    rec["ok"] = ok = (ok and rec["body"] == want_body
                                      and (rec["body"], rec["grid"]) == mirror)
                if name == "tsm2l_q8":
                    # The stream body converts each exact int32 sum once:
                    # the plain version's bits.
                    rec.update(tsm2l_plan_check(xq, yq, torch.int8, dtype))
                    rec["bits_vs_plain"] = same_bits(got, want)
                    rec["ok"] = ok = ok and rec["plan_ok"] and (
                        rec["body"] != "stream" or rec["bits_vs_plain"])
                if name in ("tsm2r_q8", "tsm2r_q8_split"):
                    # The wgmma and skinny bodies fold their exact int32
                    # sums into f32 once up to Q8_ONE_FOLD_K: the plain
                    # version's bits there.
                    rec["body"], rec["grid"] = (
                        k_tsm2r.q8_split_plan(xq, yq, S, bk) if split
                        else k_tsm2r.q8_plan(xq, yq))
                    want_body = (
                        "wgmma" if not split and (m, d1, d2) in TSM2R_Q8_WGMMA
                        else "skinny" if (m, d1, d2, S) in TSM2R_Q8_SKINNY
                        else "simt")
                    rec["bits_vs_plain"] = same_bits(got, want)
                    ok = ok and rec["body"] == want_body
                    if want_body != "simt" and depth <= Q8_ONE_FOLD_K:
                        ok = ok and rec["bits_vs_plain"]
                    rec["ok"] = ok
                if not ok:
                    bad.append(f"{name} {m}x{d1}x{d2} S={S} {dtype}")
                # wk/wv run in bf16, PowerSGD's P (n = 4) in f32.
                is_main = (timed == "main"
                           and dtype == main_dtype.get(name, f32))
                is_train = timed == "train" and (d2 == 4) == (dtype == f32)
                is_paper = timed == "paper"
                if is_main or is_train or is_paper:
                    rec.update(q8_times(entry, q, dtype, got, band,
                                        lambda: kern(q, dtype, S),
                                        lambda: plain(q, dtype, S)))
                    rec["device_ms"] = device_ms(lambda: kern(q, dtype, S),
                                                 name)
                    rec["call_device_ms"] = call_device_ms(
                        lambda: kern(q, dtype, S))
                emit(rec)
                if is_main:
                    measured[name] = rec
                elif is_train:
                    at_train.setdefault(name, []).append(rec)
                elif is_paper:
                    at_paper.setdefault(name, []).append(rec)
                del got, again, want, err
            del x, y, xq, yq, xs, ys, q
            torch.cuda.empty_cache()
    check(not bad, f"int8 kernel phase mismatch in {bad}")
    # tsm2r_q8's wide shapes run on the tensor cores, under gates the
    # __dp4a body cannot pass.
    for rec in [measured["tsm2r_q8"], *at_train["tsm2r_q8"]]:
        limit = TSM2R_Q8_MAX_MS.get(tuple(rec["shape"]))
        if limit is not None:
            check(rec["body"] == "wgmma" and rec["device_ms"] < limit,
                  f"tsm2r_q8 at {rec['shape']}: body {rec['body']}, "
                  f"{rec['device_ms']} ms on the device (limit {limit})")
    # PowerSGD's P and tsm2r_q8_split's main case stream A on the int8
    # skinny body, under a gate the __dp4a simt body cannot pass.
    for rec in [*(r for r in at_train["tsm2r_q8"] if r["shape"][2] == 4),
                measured["tsm2r_q8_split"]]:
        check(rec["body"] == "skinny"
              and rec["device_ms"] <= TSM2R_Q8_SKINNY_MAX_MS,
              f"{rec['kernel']} at {rec['shape']}: body {rec['body']}, "
              f"{rec['device_ms']} ms on the device (limit "
              f"{TSM2R_Q8_SKINNY_MAX_MS})")
    # PowerSGD's Q streams X on the packed body, under a gate the simt
    # body cannot pass.
    rec = measured["tsmt_q8_split"]
    check(rec["body"] == "packed"
          and rec["device_ms"] <= TSMT_Q8_SPLIT_MAX_MS,
          f"tsmt_q8_split at {rec['shape']}: body {rec['body']}, "
          f"{rec['device_ms']} ms on the device (limit "
          f"{TSMT_Q8_SPLIT_MAX_MS})")
    tsm2r_q8_probes(dev, uniform, gpu)
    q8_skinny_probes(dev, gpu)
    tsmt_q8_probes(dev, gpu)

    # The whole op under quant="int8" against the f32 product.
    for entry, (m, d1, d2), dtype, split in [
            ("mm", (8192, 4096, 256), bf16, "auto"),
            ("mm", (65024, 4096, 4), f32, "auto"),
            ("mm", (4096, 65536, 16), f32, "auto"),
            ("mm", (102400, 4, 4), f32, "auto"),
            ("mmt", (65536, 128, 4), f32, "never"),
            ("mmt", (65024, 4096, 4), f32, "auto")]:
        x = uniform((m, d1), dtype)
        y = uniform((d1, d2) if entry == "mm" else (m, d2), dtype)
        op = tsmm.tsmm if entry == "mm" else tsmm.tsmm_t
        xt = x if entry == "mm" else x.t()
        with tsmm.policy(quant="int8", split=split), \
                recorded() as log:
            got = op(x, y)
        oracle = torch.matmul(xt.float(), y.float())
        rel = normalised_err(got, oracle)
        ok = got.dtype == dtype and rel <= Q8_REL_TOL[dtype]
        def run(quant_mode="int8"):
            with tsmm.policy(quant=quant_mode, split=split):
                return op(x, y)

        rec = {"phase": "kernel", "op": "tsmm" if entry == "mm" else "tsmm_t",
               "quant": "int8", "shape": [m, d1, d2],
               "dtype": str(dtype)[6:], "split": split,
               "launches": [(lm.kind, lm.splits) for e in log
                            for lm in e.launches],
               "op_ms": time_ms(run),
               "library_ms": time_ms(lambda: torch.matmul(xt, y)),
               "rel_err_vs_f32": rel, "tol": Q8_REL_TOL[dtype], "ok": ok,
               "gpu": gpu}
        if (m, d1, d2) in ((8192, 4096, 256), (65024, 4096, 4)):
            # The serving shape and PowerSGD's (P through tsmm, Q through
            # tsmm_t): the int8 op (quantize passes and kernel) beside the
            # op in the caller's dtype (bf16, f32), by events and on the
            # device.
            tag = "bf16" if dtype == bf16 else "f32"
            rec.update({"op_device_ms": call_device_ms(run),
                        f"{tag}_op_ms": time_ms(lambda: run("none")),
                        f"{tag}_op_device_ms": call_device_ms(
                            lambda: run("none"))})
        emit(rec)
        check(ok, f"int8 {entry} op {m}x{d1}x{d2} {dtype}: {rel}")
        del x, y, xt, got, oracle
        torch.cuda.empty_cache()
    return measured, at_train, at_paper


def q8_times(entry, q, dtype, got, band, kern, plain) -> dict:
    """Times of one int8 kernel case: the kernel, its plain version,
    ``torch._int_mm`` and the scale fold (``library_ms``; None where it
    refuses the shape, or for TSMT, whose scales vary along the
    reduction), one ``torch.matmul`` of the dequantized operands in
    ``dtype`` (``library_dq_ms``, and its device time
    ``library_device_ms``), and the bound."""
    from repro_torch.kernels import quant

    xq, yq, xs, ys = q
    m, d1 = xq.shape
    d2 = yq.shape[1]
    library_ms = None
    if entry == "mm":
        rows = (xs.reshape(-1).repeat_interleave(band)[:m]
                * ys.reshape(()))[:, None]

        def int_mm():
            return (torch._int_mm(xq, yq).float() * rows).to(dtype)
        try:
            int_mm()
        except RuntimeError:
            pass
        else:
            library_ms = time_ms(int_mm)
    xd = quant.dequantize_blocks(xq, xs, dtype, block_rows=band)
    yd = (quant.dequantize_blocks(yq, ys, dtype) if entry == "mm"
          else quant.dequantize_blocks(yq, ys, dtype, block_rows=band))
    xd = xd if entry == "mm" else xd.t()
    b_ms, b_by = bound(xq, yq, got, 2 * m * d1 * d2, xs, ys)
    return {"kernel_ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": library_ms,
            "library_dq_ms": time_ms(lambda: torch.matmul(xd, yd)),
            "library_device_ms": call_device_ms(
                lambda: torch.matmul(xd, yd)),
            "bound_ms": b_ms, "bound_by": b_by}


def q8_dispatch(dev, uniform, counts, expect) -> dict:
    """The dispatch path under ``quant="int8"``: "never" routes the
    quickstart's shapes to tsm2r_q8, tsm2l_q8 and tsmt_q8; "auto" splits
    PowerSGD's TSMT and a TSM2R of 32 row tiles, and resolves the paper's
    TSM2R to the int8 chooser's S. Every output within the JAX int8
    criterion of the f32 product. Returns the launches it made."""
    from repro_torch.core import tsmm
    from repro_torch.kernels import ops

    f32 = torch.float32
    first = before = counts()
    a, b = uniform((4096, 4096), f32), uniform((4096, 8), f32)
    a2, b2 = uniform((102400, 4), f32), uniform((4, 4), f32)
    x, y = uniform((65536, 128), f32), uniform((65536, 4), f32)
    with tsmm.policy(split="never", quant="int8"), \
            recorded() as log:
        outs = [tsmm.tsmm(a, b), tsmm.tsmm(a2, b2), tsmm.tsmm_t(x, y)]
    torch.cuda.synchronize()
    launched = [[lm.kind for lm in e.launches] for e in log]
    errs = [normalised_err(got, want) for got, want in
            zip(outs, (a @ b, a2 @ b2, x.t() @ y))]
    grown = {n: v - before[n] for n, v in counts().items()}
    emit({"phase": "dispatch", "quant": "int8", "split": "never",
          "launched": launched, "launches": grown, "rel_err_vs_f32": errs})
    check(launched == [["tsm2r_q8"], ["tsm2l_q8"], ["tsmt_q8"]]
          and all(e.quant == "int8" and e.executor == "cuda" for e in log),
          f"int8 dispatch routes {launched}")
    check(grown == expect(tsm2r_q8=1, tsm2l_q8=1, tsmt_q8=1),
          f"int8 dispatch launches {grown}")
    check(max(errs) <= Q8_REL_TOL[f32], f"int8 dispatch errors {errs}")
    del a, b, a2, b2, x, y, outs

    a, b = uniform((16384, 16384), f32), uniform((16384, 16), f32)
    a3, b3 = uniform((4096, 65536), f32), uniform((65536, 16), f32)
    x, y = uniform((65024, 4096), f32), uniform((65024, 4), f32)
    paper_s = ops.resolve_params("tsm2r", 16384, 16384, 16, f32,
                                 tsmm.GemmPolicy(quant="int8"),
                                 device=dev)["splits"]
    q_s = ops.resolve_params("tsmt", 65024, 4096, 4, f32,
                             tsmm.GemmPolicy(quant="int8"),
                             device=dev)["splits"]
    before = counts()
    with tsmm.policy(split="auto", quant="int8"), \
            recorded() as log:
        outs = [tsmm.tsmm(a, b), tsmm.tsmm(a3, b3), tsmm.tsmm_t(x, y)]
    # PowerSGD's TSMT at a pinned S = 8: the split kernel.
    with tsmm.policy(split=8, quant="int8"), recorded() as log8:
        outs.append(tsmm.tsmm_t(x, y))
    log = log + log8
    torch.cuda.synchronize()
    resolved = [[(lm.kind, lm.splits) for lm in e.launches] for e in log]
    n_reduce = sum(k == "reduce" for r in resolved for k, _ in r)
    errs = [normalised_err(got, want) for got, want in
            zip(outs, (a @ b, a3 @ b3, x.t() @ y, x.t() @ y))]
    grown = {n: v - before[n] for n, v in counts().items()}
    want = expect(tsm2r_q8=int(paper_s == 1),
                  tsm2r_q8_split=1 + int(paper_s > 1),
                  tsmt_q8=int(q_s == 1), tsmt_q8_split=1 + int(q_s > 1),
                  sum_partials=n_reduce)
    emit({"phase": "dispatch", "quant": "int8", "split": "auto",
          "resolved": resolved, "paper_shape_int8_splits": paper_s,
          "q_int8_splits": q_s, "launches": grown, "rel_err_vs_f32": errs})
    check(resolved[0][0] == ("tsm2r_q8", paper_s)
          and resolved[1][0][0] == "tsm2r_q8" and resolved[1][0][1] > 1
          and resolved[2][0] == ("tsmt_q8", q_s)
          and resolved[3][0] == ("tsmt_q8", 8),
          f"int8 split=auto dispatch: {resolved}")
    check(grown == want, f"int8 split=auto launches {grown} != {want}")
    check(max(errs) <= Q8_REL_TOL[f32], f"int8 dispatch errors {errs}")
    del a, b, a3, b3, x, y, outs
    torch.cuda.empty_cache()
    return {n: v - first[n] for n, v in counts().items()}


def grad_phase(dev, uniform, gpu) -> None:
    """Autograd through each op on the card (the backward re-dispatches
    through tsmm and its kernels) against autograd through the op's plain
    version; then a directional finite difference of a tsm2l-routed loss
    against a float64 oracle."""
    from repro_torch.core import tsmm
    from repro_torch.kernels import ops, ref

    rtol, atol = TOL[torch.float32]
    atol *= 2.0        # the deepest backward reduction is m = 4096 terms
    for op, sx, sy, sct in [("tsm2r", (4096, 2048), (2048, 8), (4096, 8)),
                            ("tsm2l", (4096, 16), (16, 8), (4096, 8)),
                            ("tsmt", (4096, 32), (4096, 8), (32, 8))]:
        x, y = uniform(sx, torch.float32), uniform(sy, torch.float32)
        ct = uniform(sct, torch.float32)
        grads = []
        for fn in (getattr(ops, op), getattr(ref, f"{op}_ref")):
            xa = x.clone().requires_grad_(True)
            ya = y.clone().requires_grad_(True)
            with recorded() as log:
                out = fn(xa, ya)
                out.backward(ct)
            grads.append((out.detach(), xa.grad, ya.grad, log))
        (out, dx, dy, log), (r_out, r_dx, r_dy, _) = grads
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in
                ((out, r_out), (dx, r_dx), (dy, r_dy))]
        ok = all(torch.allclose(a, b, rtol=rtol, atol=atol) for a, b in
                 ((out, r_out), (dx, r_dx), (dy, r_dy)))
        routes = [(e.entry, e.kind, e.executor) for e in log]
        emit({"phase": "grad", "op": op, "shapes": [sx, sy],
              "max_err_out_dx_dy": errs, "backward_routes": routes,
              "rtol": rtol, "atol": atol, "ok": ok, "gpu": gpu})
        check(ok, f"grad phase mismatch for {op}: {errs}")
        check(len(routes) == 2 and all(r[2] in ("cuda", "torch-dense")
                                       for r in routes),
              f"grad phase backward routes {routes}")

    m, k, n = 2048, 8, 8
    a, b = uniform((m, k), torch.float32), uniform((k, n), torch.float32)
    direction = uniform((m, k), torch.float32) / m

    def oracle(a64):
        return float(torch.tanh(a64 @ b.double()).sum())

    eps = 1e-2
    fd = (oracle(a.double() + eps * direction.double())
          - oracle(a.double() - eps * direction.double())) / (2 * eps)
    aa = a.clone().requires_grad_(True)
    with recorded() as log:
        torch.tanh(tsmm.tsmm(aa, b)).sum().backward()
    analytic = float((aa.grad.double() * direction.double()).sum())
    ok = (log[0].kind == "tsm2l" and log[0].executor == "cuda"
          and abs(analytic - fd) <= 1e-2 * abs(fd))
    emit({"phase": "grad", "op": "finite_difference", "shape": [m, k, n],
          "fd": fd, "analytic": analytic, "rtol": 1e-2, "ok": ok,
          "gpu": gpu})
    check(ok, f"directional finite difference {analytic} vs {fd}")


def train_phase(dev, gpu, counts, zero_counts, quant=False):
    """Train chatglm3-6b at its published width with TRAIN_LAYERS layers:
    a dense arm's first step, then the kernel arm's TRAIN_STEPS steps (the
    training main path: counts zeroed before, read after), then one
    profiled step, then (not ``quant``) the abft phase's train arms.
    ``quant``: the train-int8 path, inside ``GemmPolicy(quant="int8")``
    with int8 PowerSGD. Returns the main path's launch counts and the
    abft arms' (launch counts, margins), None under ``quant``."""
    import contextlib
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw, powersgd, schedule
    from repro_torch.train import train_step

    cfg = dataclasses.replace(registry.get_config("chatglm3-6b"),
                              n_layers=TRAIN_LAYERS)
    n_micro = cfg.microbatch
    dcfg = pipeline.DataConfig(seed=0, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH,
                               vocab_size=cfg.vocab_size)
    opt = adamw.AdamWConfig(
        lr=schedule.linear_warmup_cosine(3e-3, 20, TRAIN_STEPS),
        weight_decay=0.1)
    ps = powersgd.PowerSGDConfig(rank=4,
                                 compress="int8" if quant else "none")
    pol = tsmm.GemmPolicy(quant="int8") if quant else None
    phase = "train-int8" if quant else "train"
    batches = [{k: torch.from_numpy(v).to(dev, torch.long)
                for k, v in pipeline.batch_for_step(dcfg, i).items()}
               for i in range(TRAIN_STEPS + 1)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    heads = ("embed.table", "lm_head.table")
    captured = {}

    def make_step(tag):
        def transform(grads, st):
            out, st, met = powersgd.compress_tree(ps, grads, st)
            if tag not in captured:   # the first step's compressed grads
                # (the dense arm's kept on the host, off the kernel arm's
                # peak)
                captured[tag] = {n: (out[n].detach().cpu() if tag == "dense"
                                     else out[n].detach().clone())
                                 for n in heads}
            return out, st, met
        return train_step.make_train_step(cfg, opt, n_micro=n_micro,
                                          grad_transform=transform)

    def fresh_state():
        state = train_step.init_train_state(0, cfg, opt, device=dev)
        state["extra"] = powersgd.init(ps, state["params"])
        return state

    # The dense arm: the same state and batch as the kernel arm's first
    # step, every GEMM on torch.matmul.
    state = fresh_state()
    with tsmm.policy(mode="dense"), recorded() as log:
        m = make_step("dense")(state, batches[0])[1]
    check(log and all(e.executor == "torch-dense" for e in log),
          "train dense arm routes")
    dense = {k: float(m[k]) for k in ("loss", "grad_norm")}
    del state, m, log   # no reference to the dense arm's state is left
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    state = fresh_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # What the train state holds before any step (parameters, AdamW
    # moments, PowerSGD state): the part of the peak no activation owns.
    state_gb = torch.cuda.memory_allocated() / 2**30 - before_gb
    n_params = sum(p.numel() for p in state["params"].parameters())
    check(sorted(state["extra"]) == list(heads),
          f"compressed leaves {sorted(state['extra'])}")
    step = make_step("kernel")
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    mb_tokens = tokens // n_micro
    # wk/wv of every layer and microbatch, twice under remat (the
    # backward runs each layer's forward again), and PowerSGD's 2 P.
    check(cfg.remat, f"{phase} runs without remat")
    per_step_tsm2r = 2 * TRAIN_LAYERS * n_micro * (2 if cfg.remat else 1) + 2
    # PowerSGD's P = G Q of embed and lm_head (f32 gradients): the S the
    # chooser resolves for the kernel arm's scope.
    p_shape = (cfg.vocab_size, cfg.d_model, ps.rank)
    p_splits = ops.resolve_params("tsm2r", *p_shape, torch.float32,
                                  pol or tsmm.GemmPolicy(),
                                  device=dev)["splits"]
    # PowerSGD's Q = G^T P of both leaves: S = 1 is the one-launch kernel,
    # which spreads m over its own plan of slices.
    q_splits = ops.resolve_params("tsmt", *p_shape, torch.float32,
                                  pol or tsmm.GemmPolicy(),
                                  device=dev)["splits"]
    q_kernel = ("tsmt_q8" if quant else "tsmt") + ("_split" if q_splits > 1
                                                   else "")
    if quant:
        want_step = {n: 0 for n in counts()}
        want_step[q_kernel] = 2
        want_step["tsm2r_q8"] = per_step_tsm2r - 2 * (p_splits > 1)
        want_step["tsm2r_q8_split"] = 2 * (p_splits > 1)
        # Both operands of each int8 op, and int8 PowerSGD's P and Q of
        # each compressed leaf, through the fused quantize pass.
        want_step["quantize"] = 2 * (per_step_tsm2r + 2) + 2 * len(heads)
    zero_counts()
    step_ms, per_step, records = [], [], []
    for i in range(TRAIN_STEPS):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (tsmm.policy(pol) if pol else contextlib.nullcontext()), \
                recorded() as log:
            state, m = step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grown = {n: v - before[n] for n, v in counts().items()}
        per_step.append(grown)
        tsmt_splits = [lm.splits for e in log if e.kind == "tsmt"
                       for lm in e.launches if lm.kind in ("tsmt",
                                                           "tsmt_q8")]
        tsmt_slices = [lm.grid[2] for e in log if e.kind == "tsmt"
                       for lm in e.launches if lm.kind in ("tsmt",
                                                           "tsmt_q8")]
        p_resolved = [lm.splits for e in log
                      if (e.entry, e.shape) == ("mm", p_shape)
                      for lm in e.launches if lm.kind != "reduce"]
        bwd = [e for e in log if (e.entry, e.shape) in {
            ("mm", (mb_tokens, kv, cfg.d_model)),       # da = ct w^T
            ("mmt", (mb_tokens, cfg.d_model, kv))}]     # dw = x^T ct
        rec = {k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                        "accuracy", "powersgd_compression")}
        rec.update(step=i + 1, step_ok=bool(m["step_ok"]), launches=grown,
                   tsmt_splits=tsmt_splits, tsmt_slices=tsmt_slices,
                   p_splits=p_resolved, ms=step_ms[-1])
        records.append(rec)
        check(rec["step_ok"], f"{phase} step {i + 1} not ok: {rec}")
        check(p_resolved == [p_splits, p_splits],
              f"{phase} P projections in step {i + 1}: S={p_resolved}")
        if quant:
            check(grown == want_step,
                  f"train-int8 launches in step {i + 1}: {grown}")
        else:
            check(grown["tsm2r"] == per_step_tsm2r,
                  f"tsm2r launches in step {i + 1}: {grown['tsm2r']}")
            check(grown[q_kernel] == 2
                  and grown["tsmt"] + grown["tsmt_split"] == 2,
                  f"tsmt launches in step {i + 1}: {grown}")
        # Q at the resolved S, its slices spread over the card either way.
        check(tsmt_splits == [q_splits] * 2 and min(tsmt_slices) > 1,
              f"{phase} Q projections in step {i + 1}: S={tsmt_splits}, "
              f"slices {tsmt_slices}")
        check(len(bwd) == 2 * 2 * TRAIN_LAYERS * n_micro
              and all(e.executor == "torch-dense" for e in bwd),
              f"wk/wv backward routes in step {i + 1}: {len(bwd)}")
        del log, m
    main_train = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # The main path ends here; what follows checks it and measures it.
    head_err = {n: normalised_err(captured["kernel"][n],
                                  captured["dense"][n].to(dev))
                for n in heads}
    loss_err = abs(records[0]["loss"] - dense["loss"]) / abs(dense["loss"])
    gnorm_err = (abs(records[0]["grad_norm"] - dense["grad_norm"])
                 / dense["grad_norm"])
    head_tol = Q8_GRAD_TOL if quant else LOGIT_TOL
    check(max(head_err.values()) <= head_tol and loss_err <= LOGIT_TOL
          and gnorm_err <= LOGIT_TOL,
          f"{phase} kernel vs dense arm: loss {loss_err} grad norm "
          f"{gnorm_err} compressed grads {head_err}")
    captured.update(kernel=None, dense=None)   # free; capture no more
    with (tsmm.policy(pol) if pol else contextlib.nullcontext()):
        prof = device_profile(lambda: step(state, batches[TRAIN_STEPS]))
    mid_ms = statistics.median(step_ms)
    MEDIAN_STEP_MS[phase] = mid_ms
    emit({"phase": phase, "model": cfg.name, "quant": ps.compress, "layers": cfg.n_layers,
          "params": n_params, "dtype": cfg.dtype, "n_micro": n_micro,
          "tokens_per_step": tokens, "init_s": init_s, "steps": records,
          "step_ms": step_ms, "median_step_ms": mid_ms,
          "tokens_per_s": tokens / mid_ms * 1e3, "peak_mem_gb": peak_gb,
          "state_mem_gb": state_gb, "mem_before_state_gb": before_gb,
          "dense_arm": dense, "dense_arm_loss_err": loss_err,
          "dense_arm_grad_norm_err": gnorm_err,
          "dense_arm_compressed_grad_err": head_err,
          "compressed_grad_tol": head_tol, "p_splits": p_splits,
          "q_splits": q_splits, "q_kernel": q_kernel,
          "remat": cfg.remat, "tsm2r_launches_per_step": per_step_tsm2r,
          "gpu": gpu})
    emit({"phase": "profile", "window": f"{phase} step", **prof,
          "unprofiled_ms": mid_ms,
          "busy_share": prof["device_busy_ms"] / mid_ms, "gpu": gpu})
    PROFILES.setdefault((phase, "step"), {**prof, "unprofiled_ms": mid_ms})
    del state
    torch.cuda.empty_cache()
    abft = None
    if not quant:
        PATH["name"] = "abft_train"
        abft = abft_train_arms(dev, gpu, cfg, step, fresh_state, batches,
                               records, counts, zero_counts,
                               ((mb_tokens, cfg.d_model, kv), p_shape))
    del batches
    torch.cuda.empty_cache()
    return main_train, abft


# ---------------------------------------------------------------------------
# The abft phase: GemmPolicy.abft and ft/inject.py on the serve and train
# paths, ft/abft.py's offline tree API on the train state
# ---------------------------------------------------------------------------

CAPTURE = "abft-capture"
# (kernel, (m, d1, d2), stages): where the guard's checksum GEMMs meet the
# kernels on the serve and train paths (contracts.abft_stage_shapes of
# wk/wv, P and Q), f32. The u stage of wk/wv is dense (no kernel).
ABFT_SHAPES = [
    ("tsmt", (4096, 256, 2), "c_ref of wk/wv; c_out of train wk/wv"),
    ("tsmt", (8192, 256, 2), "c_out of serve wk/wv"),
    ("tsmt", (65024, 4096, 2), "u of P"),
    ("tsmt", (4096, 4, 2), "c_ref of P; c_out of Q"),
    ("tsmt", (65024, 4, 2), "c_out of P"),
    ("tsmt", (65024, 2, 4), "c_ref of Q"),
    ("tsm2r", (65024, 4096, 2), "v of Q"),
    # mesh-rwkv's offline tree check of rwkv6-1.6b (encode_leaf; every
    # other leaf's checksum is dense)
    ("tsmt", (65536, 2048, 2), "tree check of embed / lm_head"),
    ("tsmt", (2048, 64, 2), "tree check of time_mix.w_lora.a"),
]


class Capture:
    """A registered executor that runs the route the dispatcher would have
    chosen (``cuda`` for a kernel kind, ``torch-dense`` else) and keeps,
    for each watched (entry, kind, shape), copies of the operands and
    output of its first call (the optimizer updates weights in place) and
    the fault site and output of every call made in the ``root`` fault
    scope (so not in a recompute's replay)."""

    def __init__(self, watched):
        self.watched, self.root = set(watched), None
        self.first, self.calls = {}, {}

    def __call__(self, entry, kind, a, b, p):
        from repro_torch.core import tsmm
        from repro_torch.ft import inject

        route = "torch-dense" if kind == "dense" else "cuda"
        out = tsmm.executors()[route](entry, kind, a, b, p)
        key = (entry, kind, (a.shape[0], a.shape[1], b.shape[1]))
        scope = inject.current_scope()
        if key in self.watched and scope is not None and scope is self.root:
            if key not in self.first:
                self.first[key] = tuple(t.detach().clone()
                                        for t in (a, b, out))
            self.calls.setdefault(key, []).append((scope.sites_seen - 1,
                                                   out))
        return out


@contextlib.contextmanager
def capturing(watched):
    """Register a ``Capture`` as executor ``CAPTURE`` for the scope."""
    from repro_torch.core import tsmm

    cap = Capture(watched)
    tsmm.register_executor(CAPTURE, cap)
    try:
        yield cap
    finally:
        tsmm.unregister_executor(CAPTURE)


def max_cell(t) -> tuple[int, int]:
    """(row, col) of the largest |value| of a 2-D tensor."""
    flat = int(t.float().abs().argmax())
    return divmod(flat, t.shape[1])


def exponent_bit(t, top: bool = False) -> int:
    """The bit f32's 29 is in ``t``'s dtype (bf16 holds f32's top 16 bits,
    so 13), or with ``top`` the exponent's top bit (f32 30, bf16 14)."""
    return (30 if top else 29) - (16 if t.element_size() == 2 else 0)


def abft_margin(name, entry, a, b, out) -> dict:
    """The guard's detection margin on a real protected call: each
    column's largest checksum deviation over its tolerance
    (``ft.abft.detect``), the largest and the median over the columns."""
    from repro_torch.core import tsmm
    from repro_torch.ft import abft

    a, b, out = a.detach(), b.detach(), out.detach()
    c_out, c_ref, rows, red, _ = tsmm._abft_checksums(
        entry, a, b, out, tsmm.GemmPolicy())
    bad, tol = abft.detect(c_out, c_ref, rows=rows, reduction=red,
                           eps=abft.tolerance_eps(out.dtype),
                           amax=out.float().abs().amax(dim=0))
    ratio = (c_out[:, :2] - c_ref[:, :2]).abs().amax(dim=1) / tol
    return {"name": name, "entry": entry,
            "shape": [a.shape[0], a.shape[1], b.shape[1]],
            "dtype": str(out.dtype)[6:], "rows": rows, "reduction": red,
            "margin": float(ratio.max()),
            "median_margin": float(ratio.median()),
            "clean_detections": int(bad.sum())}


def guard_stages(log) -> dict:
    """The checksum GEMMs of each guarded event in a dispatch log (the
    three events that follow it), counted by stage route: kind, shape and
    the kernels launched."""
    out = {}
    for i, e in enumerate(log):
        if e.abft == "none":
            continue
        for c in log[i + 1:i + 4]:
            key = (f"{c.entry} {c.kind} {list(c.shape)} "
                   f"{[lm.kind for lm in c.launches]}")
            out[key] = out.get(key, 0) + 1
    return out


def host_sync_free(x, w) -> dict:
    """Run one guarded ``tsmm`` on the serve wk operands under each mode,
    with a bit flip in its output, in CUDA sync-debug "error" mode: True
    where nothing synchronised the host with the device."""
    from repro_torch.core import tsmm
    from repro_torch.ft import inject

    r, c = max_cell(x[:8] @ w)
    fault = inject.GemmFault(site=0, operand="out", row=r, col=c,
                             bit=exponent_bit(x))
    out = {}
    for mode in ("verify", "correct"):
        tsmm.tsmm(x, w, policy=tsmm.GemmPolicy(abft=mode))   # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with inject.faults(fault):
                tsmm.tsmm(x, w, policy=tsmm.GemmPolicy(abft=mode))
            out[mode] = True
        except RuntimeError as err:
            out[mode] = str(err)[:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return out


def abft_serve_arm(dev, gpu, cfg, params, prompts, counts, zero_counts):
    """The abft phase's serve arm (its own path): a prefill through a
    capture executor finds the first wk call's site and output; one
    guarded call on its operands per mode must not synchronise the host
    (``host_sync_free``); then an unguarded prefill, a clean "verify" and
    a clean "correct" prefill (each after a warm-up: 56 guarded events,
    logits bit-equal) and a "correct" prefill with a bit flip in the
    largest cell of the first wk output (repaired: logits bit-equal),
    each timed. Returns the path's launch counts (the two clean guarded
    prefills alone: counts zeroed just before, read just after; the fault
    prefill's are reported apart) and the wk/wv margin."""
    from repro_torch.core import tsmm
    from repro_torch.ft import inject
    from repro_torch.models import model
    from repro_torch.serve import engine

    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    key = ("mm", "tsm2r", (BATCH * PROMPT, cfg.d_model, kv))
    prefill_step, _ = engine.make_serve_fns(cfg)
    per_prefill = 2 * cfg.n_layers

    def prefill(**pol):
        cache = model.init_cache(cfg, BATCH, PROMPT, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tsmm.policy(**pol), recorded() as log:
            logits, _ = prefill_step(params, {"tokens": prompts}, cache)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t0) * 1e3, log

    zero_counts()
    with capturing({key}) as cap, inject.faults() as root:
        cap.root = root
        prefill(executor=CAPTURE)
    (site, first_out) = cap.calls[key][0]
    margin = abft_margin("serve wk/wv", "mm", *cap.first[key])
    r, c = max_cell(first_out)
    fault = inject.GemmFault(site=site, operand="out", row=r, col=c,
                             bit=exponent_bit(first_out))
    x, w, _ = cap.first[key]
    del cap, first_out
    no_sync = host_sync_free(x, w)
    check(all(no_sync.values()), f"the guard synchronised the host: "
          f"{no_sync}")
    del x, w
    clean, clean_ms, _ = prefill()
    for mode in ("verify", "correct"):
        prefill(abft=mode)       # warm-up: the guard's first launches
    # The path: one clean "verify" and one clean "correct" prefill, each
    # counted on its own.
    times, per_mode = {}, {}
    zero_counts()
    for mode in ("verify", "correct"):
        before = counts()
        logits, times[mode], log = prefill(abft=mode)
        per_mode[mode] = {n: v - before[n] for n, v in counts().items()}
        guarded = [e for e in log if e.abft == mode]
        check(len(guarded) == per_prefill and {e.kind for e in guarded}
              == {"tsm2r"}, f"serve {mode}: {len(guarded)} guarded events")
        check(same_bits(logits, clean), f"serve {mode} prefill logits "
              "differ from the unguarded prefill's")
        if mode == "verify":
            vlog = log
        del logits, log
    launches = counts()
    check(per_mode["verify"] == per_mode["correct"],
          f"serve launches differ by mode: {per_mode}")
    zero_counts()
    with inject.faults(fault) as scope:
        fixed, correct_ms, clog = prefill(abft="correct")
    fault_launches = counts()
    check(scope.applied == [fault], f"serve fault not applied: "
          f"{scope.applied} (plan {fault})")
    check([e.faults for e in clog if e.faults] == [(fault,)],
          "serve fault stamped on one guarded event")
    check(same_bits(fixed, clean), "serve correct prefill did not repair "
          f"the fault bit for bit: {normalised_err(fixed, clean)}")
    prof = device_profile(lambda: prefill(abft="verify"))
    emit({"phase": "profile", "window": "abft verify prefill", **prof,
          "unprofiled_ms": times["verify"],
          "busy_share": prof["device_busy_ms"] / times["verify"],
          "gpu": gpu})
    emit({"phase": "abft", "arm": "serve", "model": cfg.name,
          "batch": BATCH, "prompt": PROMPT, "fault": dataclasses.asdict(fault),
          "first_wk_site": site, "guarded_per_prefill": len(guarded),
          "checksum_stages_per_prefill": guard_stages(vlog),
          "prefill_ms": clean_ms, "verify_prefill_ms": times["verify"],
          "correct_prefill_ms": times["correct"],
          "correct_fault_prefill_ms": correct_ms,
          "clean_bit_equal": True, "correct_fault_bit_equal": True,
          "host_sync_free": no_sync,
          "launches": launches, "launches_per_prefill": per_mode,
          "fault_prefill_launches": fault_launches, "gpu": gpu})
    return launches, margin


def abft_train_arms(dev, gpu, cfg, step, fresh_state, batches, clean,
                    counts, zero_counts, shapes) -> tuple[dict, list]:
    """The abft phase's train arms (their own path): 3 "verify" steps from
    the kernel arm's state and batches (bit-equal loss and grad norm, 66
    guarded tsm2r and 2 guarded tsmt events a step; the first through a
    capture executor, for the sites and the margins' operands), one
    "verify" and one "correct" step with a bit flip in the largest cell of
    the last microbatch's first wk output (poisoned, then repaired bit for
    bit, in the forward and in its remat recompute), and the offline tree
    API on the last state's parameters. Returns the path's launch counts
    (the verify steps alone: counts zeroed just before, read just after;
    the fault arms' and the offline API's are reported apart) and the
    margins of train wk/wv, P and Q."""
    import math

    from repro_torch.core import tsmm
    from repro_torch.ft import abft, inject

    wkv, p_shape = shapes
    # wk/wv of every layer and microbatch, twice under remat, and P of the
    # two compressed leaves on tsm2r; their Q on tsmt.
    want = {"tsm2r": 2 * cfg.n_layers * cfg.microbatch
            * (2 if cfg.remat else 1) + 2, "tsmt": 2}
    keys = {"train wk/wv": ("mm", "tsm2r", wkv), "P": ("mm", "tsm2r", p_shape),
            "Q": ("mmt", "tsmt", p_shape)}
    state = fresh_state()
    recs, logs_stages = [], None
    with capturing(keys.values()) as cap:
        # The path: the verify steps alone (counts zeroed just before,
        # read just after; the fault arms and the offline API apart).
        zero_counts()
        for i in range(TRAIN_STEPS):
            pin = {"executor": CAPTURE} if i == 0 else {}
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with tsmm.policy(abft="verify", **pin), \
                    inject.faults() as root, recorded() as log:
                cap.root = root
                state, m = step(state, batches[i])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            guarded = {k: sum(e.abft == "verify" and e.kind == k
                              for e in log) for k in ("tsm2r", "tsmt")}
            rec = {"step": i + 1, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "step_ok": bool(m["step_ok"]), "ms": ms,
                   "guarded": guarded,
                   "launches": {n: v - before[n]
                                for n, v in counts().items()}}
            rec["bit_equal"] = (rec["loss"] == clean[i]["loss"]
                                and rec["grad_norm"] == clean[i]["grad_norm"])
            recs.append(rec)
            if logs_stages is None:
                logs_stages = guard_stages(log)
            check(rec["step_ok"] and rec["bit_equal"], f"train verify step "
                  f"{i + 1} against the unguarded arm's {clean[i]}: {rec}")
            check(guarded == want, f"train verify step {i + 1} guarded "
                  f"events {guarded}, expected {want}")
            del log, m
        launches = counts()
        margins = [abft_margin(n, k[0], *cap.first[k])
                   for n, k in keys.items()]
        verify_ms = statistics.median(x["ms"] for x in recs)
        with tsmm.policy(abft="verify"):
            prof = device_profile(lambda: step(state, batches[TRAIN_STEPS]))
        emit({"phase": "profile", "window": "abft verify train step", **prof,
              "unprofiled_ms": verify_ms,
              "busy_share": prof["device_busy_ms"] / verify_ms, "gpu": gpu})
        # The last microbatch's first wk: its forward sites follow the
        # earlier microbatches' (backward GEMMs and recomputes are no
        # sites), 2 wk/wv calls a layer.
        wk_calls = cap.calls[keys["train wk/wv"]]
        site, out = wk_calls[(cfg.microbatch - 1) * 2 * cfg.n_layers]
        check(len(wk_calls) == cfg.microbatch * 2 * cfg.n_layers,
              f"wk/wv calls in the root scope: {len(wk_calls)}")
        r, c = max_cell(out)
        fault = inject.GemmFault(site=site, operand="out", row=r, col=c,
                                 bit=exponent_bit(out))
        del wk_calls, out
    arms = {}
    for mode in ("verify", "correct"):
        del state
        torch.cuda.empty_cache()
        state = fresh_state()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tsmm.policy(abft=mode), inject.faults(fault) as scope, \
                recorded() as log:
            state, m = step(state, batches[0])
        torch.cuda.synchronize()
        arm = {"ms": (time.perf_counter() - t0) * 1e3,
               "launches": counts(),
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "step_ok": bool(m["step_ok"]),
               "applied": [dataclasses.asdict(f) for f in scope.applied],
               # the forward's event and the recompute's replay
               "faulted_events": [e.abft for e in log if e.faults]}
        arms[mode] = arm
        check(scope.applied == [fault], f"train {mode} fault applied "
              f"{scope.applied} (plan {fault})")
        check(arm["faulted_events"] == [mode, mode],
              f"train {mode}: the fault landed on {arm['faulted_events']}")
        if mode == "verify":
            check(math.isnan(arm["loss"]) and not arm["step_ok"],
                  f"train verify fault not poisoned: {arm}")
        else:
            check(arm["step_ok"] and arm["loss"] == clean[0]["loss"]
                  and arm["grad_norm"] == clean[0]["grad_norm"],
                  f"train correct fault not repaired bit for bit: {arm} "
                  f"against {clean[0]}")
        del log, m
    # Offline: checksums of the state's parameters, then a flip of the
    # exponent's top bit in the largest cell of embed.table (a bf16 flip
    # of f32 bit 29's place shrinks the cell below the bf16 tolerance).
    params = dict(state["params"].named_parameters())
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = abft.encode_tree(params)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    ok, _ = abft.verify_tree(params, sums)
    table = params["embed.table"]
    r, c = max_cell(table)
    bit = exponent_bit(table, top=True)
    bad = {**params, "embed.table": inject.flip_bit(table, r, c, bit)}
    caught, _ = abft.verify_tree(bad, sums)
    ok_before, fixed = abft.verify_and_correct_tree(bad, sums)
    restored = all(same_bits(fixed[n].detach(), t.detach())
                   for n, t in params.items())
    leaves = sum(v is not None for v in sums.values())
    offline_launches = counts()
    check(bool(ok) and not bool(caught) and not bool(ok_before) and restored,
          f"offline ABFT: clean ok {bool(ok)}, flip caught {not bool(caught)}"
          f", detected {not bool(ok_before)}, restored {restored}")
    emit({"phase": "abft", "arm": "train", "model": cfg.name,
          "layers": cfg.n_layers, "verify_steps": recs,
          "median_verify_step_ms": verify_ms,
          "median_unguarded_step_ms": statistics.median(
              x["ms"] for x in clean),
          "checksum_stages_per_step": logs_stages,
          "fault": dataclasses.asdict(fault), "fault_arms": arms,
          "offline": {"leaves_encoded": leaves, "leaves": len(params),
                      "encode_ms": encode_ms, "flip": [r, c, bit],
                      "clean_ok": bool(ok), "restored_bit_for_bit": restored,
                      "launches": offline_launches},
          "launches": launches, "gpu": gpu})
    del state, params, bad, fixed, sums
    torch.cuda.empty_cache()
    return launches, margins


SCHEME_BAND = 256   # the JAX ``quantize_param`` default band


def scheme_q8(x, band: int):
    """int8 codes and (bands, 1) f32 scales of a 2-D ``x`` as the JAX
    package forms them (``kernels/quant.py:56``): rows zero-padded to whole
    bands, absmax / 127 per band (1 for an all-zero band), divide, round
    half to even, clip to +-127. Written here apart from the port's
    ``kernels/quant.py`` so the serve-int8 scheme arm does not share it."""
    m = x.shape[0]
    bands = -(-m // band)
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, bands * band - m))
    amax = xf.reshape(bands, -1).abs().amax(dim=1)
    # JAX divides; PyTorch's CUDA division by a Python number multiplies by
    # the rounded reciprocal instead, so divide by a tensor.
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    codes = (xf / scale.repeat_interleave(band)[:, None]).round()
    return codes.clamp(-127.0, 127.0)[:m].to(torch.int8), scale[:, None]


def scheme_tsm2r(a, b, policy):
    """The JAX int8 TSM2R scheme on ``a @ b``: A per ``SCHEME_BAND``-row
    band, B per tensor, then the plain version's exact integer product
    with the scales folded, in ``a``'s dtype. Stands in for
    ``kernels.ops._tsm2r_impl`` in the serve-int8 scheme arm."""
    from repro_torch.kernels import ref

    a_q, a_s = scheme_q8(a, SCHEME_BAND)
    b_q, b_s = scheme_q8(b, b.shape[0])
    return ref.tsm2r_q8_ref(a_q, b_q, a_s, b_s, SCHEME_BAND, a.dtype)


def serve_int8_phase(dev, gpu, counts, zero_counts, expect) -> dict:
    """Serve chatglm3-6b from int8 weight records under
    ``GemmPolicy(quant="int8")`` (the serve-int8 main path: counts zeroed
    before, read after), then check it against a dense arm on the same
    records and a scheme arm and profile one prefill. Returns the main
    path's launch counts."""
    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.kernels import ops, quant
    from repro_torch.models import model
    from repro_torch.serve import engine

    cfg = registry.get_config("chatglm3-6b")
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device=dev)
    dense_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    qw = quant.quantize_weights(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kept_bytes = sum(p.numel() * p.element_size()
                     for p in params.parameters())
    seg = "segments.0."
    check(sorted(qw.records) == sorted(
        ["embed.table", "lm_head.table"]
        + [seg + n for n in ("attn.bq", "attn.bk", "attn.bv", "norm1.scale",
                             "norm2.scale")]),
        f"records of {sorted(qw.records)}")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    pol = tsmm.GemmPolicy(quant="int8")
    per_prefill = 2 * cfg.n_layers
    kv = cfg.n_kv_heads * cfg.resolved_head_dim

    zero_counts()
    with recorded() as log:
        t0 = time.perf_counter()
        out = engine.generate(qw, cfg, prompts, NEW, policy=pol, device=dev)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    check(counts() == expect(tsm2r_q8=per_prefill),
          f"serve-int8 launches of one request {counts()}")
    routed = [e for e in log if e.launches]
    check(len(routed) == per_prefill and all(
        e.executor == "cuda" and e.quant == "int8"
        and [lm.kind for lm in e.launches] == ["tsm2r_q8"]
        and e.shape == (BATCH * PROMPT, cfg.d_model, kv) for e in routed),
        f"serve-int8 prefill routes {routed[:2]}")
    decode_events = [e for e in log if e.shape[0] == BATCH]
    check(len(decode_events) == (NEW - 1) * cfg.n_layers * 7 and all(
        e.executor == "torch-dense" for e in decode_events),
        "every int8 decode projection goes to torch-dense")
    check(out.shape == (BATCH, NEW) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"serve-int8 output {out.shape}")

    prefill_step, decode_step = engine.make_serve_fns(cfg, policy=pol)
    cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(qw, {"tokens": prompts}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(1, NEW):
        _, cache = decode_step(qw, out[:, i - 1:i], PROMPT + i - 1, cache)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
    del cache
    # The main path ends here; what follows checks it and measures it.
    main = counts()
    check(main == expect(tsm2r_q8=2 * per_prefill),
          f"serve-int8 main path launches {main}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    dense_prefill, _ = engine.make_serve_fns(
        cfg, policy=tsmm.GemmPolicy(mode="dense", quant="int8"))
    with recorded() as log:
        dense_logits, _ = dense_prefill(
            qw, {"tokens": prompts},
            model.init_cache(cfg, BATCH, PROMPT, device=dev))
    check(all(e.executor == "torch-dense" for e in log),
          "serve-int8 dense arm routes")
    dense_err = normalised_err(logits, dense_logits)
    check(dense_err <= Q8_GRAD_TOL, f"serve-int8 vs dense arm {dense_err}")
    # The scheme arm: the same routing, every wk/wv product taken by
    # scheme_tsm2r instead of ops.py's quantization and the kernel (no
    # launch, so nothing is counted). Equal bits show that ops.py applies
    # the JAX scheme and the kernel equals its plain version at every
    # prefill launch: the dense arm's distance is the scheme's own.
    impl = ops._tsm2r_impl
    ops._tsm2r_impl = scheme_tsm2r
    try:
        scheme_logits, _ = prefill_step(
            qw, {"tokens": prompts},
            model.init_cache(cfg, BATCH, PROMPT, device=dev))
    finally:
        ops._tsm2r_impl = impl
    scheme_err = normalised_err(logits, scheme_logits)
    check(torch.equal(logits, scheme_logits),
          f"serve-int8 vs scheme arm {scheme_err}")
    emit({"phase": "serve-int8", "model": cfg.name, "dtype": cfg.dtype,
          "batch": BATCH, "prompt": PROMPT, "new": NEW, "init_s": init_s,
          "records": sorted(qw.records), "records_bytes": qw.nbytes(),
          "dense_bytes_replaced": dense_bytes - kept_bytes,
          "param_bytes_dense": dense_bytes,
          "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": BATCH * PROMPT / prefill_ms * 1e3,
          "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": BATCH / decode_ms * 1e3,
          "greedy_request_s": greedy_s,
          "tsm2r_q8_launches_per_prefill": per_prefill,
          "dense_arm_err": dense_err, "dense_arm_tol": Q8_GRAD_TOL,
          "scheme_arm_err": scheme_err,
          "scheme_arm_dense_err": normalised_err(scheme_logits,
                                                 dense_logits),
          "peak_mem_gb": peak_gb, "gpu": gpu})
    cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    rec = device_profile(
        lambda: prefill_step(qw, {"tokens": prompts}, cache))
    emit({"phase": "profile", "window": "int8 prefill", **rec,
          "unprofiled_ms": prefill_ms,
          "busy_share": rec["device_busy_ms"] / prefill_ms, "gpu": gpu})
    del qw, params, cache, prompts, out, logits, dense_logits, scheme_logits
    torch.cuda.empty_cache()
    return main


def serve_step_by_step(params, cfg, prompts, out, dev, per_prefill, counts,
                       extras=None):
    """A prefill of ``prompts`` (B x S0, with ``extras`` in its batch) and
    cached decode steps of ``out``'s first NEW - 1 tokens through
    ``engine.make_serve_fns``, timed on the host clock; the prefill must
    launch ``per_prefill`` kernels (the sum of ``counts()``). Returns (the
    logits of every step, prefill ms, decode ms a step)."""
    from repro_torch.models import model
    from repro_torch.serve import engine

    def count():
        return sum(counts().values())

    prefill_step, decode_step = engine.make_serve_fns(cfg)
    batch, prompt = prompts.shape
    cache = model.init_cache(cfg, batch, prompt + NEW, device=dev)
    before = count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": prompts,
                                          **(extras or {})}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(count() - before == per_prefill,
          f"{cfg.name} prefill_step launches")
    step_logits = [logits]
    t0 = time.perf_counter()
    for i in range(1, NEW):
        logits, cache = decode_step(params, out[:, i - 1:i], prompt + i - 1,
                                    cache)
        step_logits.append(logits)
    torch.cuda.synchronize()
    return step_logits, prefill_ms, (time.perf_counter() - t0) * 1e3 / (
        NEW - 1)


def serve_ref(prompts, out, sampled, step_logits, prefill_ms,
              decode_ms, extras=None) -> dict:
    """Host copies of a plain serve run (``SERVE_REF``'s entry): the
    prompts and the batch's extras, the greedy and sampled tokens, every
    step's logits, and the prefill ms and decode ms a step of
    ``serve_step_by_step``."""
    return {"prompts": prompts.cpu(), "out": out.cpu(),
            "extras": {k: v.cpu() for k, v in (extras or {}).items()},
            "sampled": sampled.cpu(),
            "step_logits": [t.cpu() for t in step_logits],
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def profile_serve(engine, model, params, cfg, prompts, out, dev, step_ms,
                  gpu, extras=None) -> None:
    """Trace one prefill (of ``prompts`` and ``extras``) and two decode
    steps with ``torch.profiler`` and print, per window, the device time by
    kernel and by category and the device's busy share of the same work's
    unprofiled time (each line names the model)."""
    prefill_step, decode_step = engine.make_serve_fns(cfg)
    batch = {"tokens": prompts, **(extras or {})}
    for window in ("prefill", "decode"):
        cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        if window == "decode":
            _, cache = prefill_step(params, batch, cache)
        torch.cuda.synchronize()
        if window == "prefill":
            rec = device_profile(
                lambda: prefill_step(params, batch, cache))
        else:
            rec = device_profile(lambda: [
                decode_step(params, out[:, i - 1:i], PROMPT + i - 1, cache)
                for i in (1, 2)])
        emit({"phase": "profile", "window": window, "model": cfg.name,
              **rec, "unprofiled_ms": step_ms[window],
              "busy_share": rec["device_busy_ms"] / step_ms[window],
              "gpu": gpu})
        PROFILES.setdefault((cfg.name, window),
                            {**rec, "unprofiled_ms": step_ms[window]})
        del cache


# The dispatch events that each path's record scopes saw, kept for the
# contracts line: path name -> DispatchEvents.
RECORDED: dict = {}
# The first profile of each (model or train phase, window), with the
# window's unprofiled ms: what the roofline and mesh phases read of the
# serve phase's prefill and the train phase's step (traced once).
PROFILES: dict = {}
PATH = {"name": "kernel"}
# Each train path's median step ms, for the launch phase's line.
MEDIAN_STEP_MS = {}


@contextlib.contextmanager
def recorded():
    """``tsmm.record_dispatches()``, whose events are also kept under the
    current path (``PATH``) for the contracts line."""
    from repro_torch.core import tsmm

    with tsmm.record_dispatches() as log:
        yield log
    RECORDED.setdefault(PATH["name"], []).extend(log)


def _c_plan(kind, lm) -> tuple:
    """(body, grid) of a recorded launch as its library's plan query
    decides them: tsm2r's and tsm2r_q8's plan and split_plan queries,
    tsm2l's and tsm2l_q8's tsm2l_plan, tsmt_q8's and tsmt_q8_split's
    tsmt_q8_plan (its slices from the Python plan, which the launcher is
    given), and for f32/bf16 tsmt the tile table's grid query."""
    from repro_torch.kernels import _build

    tags = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
    (m, d1, d2), p, s = lm.shape, lm.params, lm.splits
    tag = tags[lm.dtype]
    if kind == "tsm2r":
        pa, pb = p["ptrs"]["a"], p["ptrs"]["b"]
        if s == 1:
            return _build.plan(m, d1, d2, tag, pa, pb)
        return _build.split_plan(m, d1, d2, s, p["slice"], tag, pa)
    if kind == "tsm2l":
        out = tags[p.get("out_dtype", torch.float32)]
        body, grid, _ = _build.tsm2l_plan(m, d1, d2, tag, p["ptrs"]["a"], out)
        return body, grid
    if lm.dtype == torch.int8:
        body, tiles = _build.tsmt_q8_plan(m, d1, d2, p["ptrs"]["x"],
                                          p["ptrs"]["y"], s > 1)
        return body, (*tiles, p["slices"])
    return "simt", _build.grid("tsmt_split", m, d1, d2, p["slices"])


# The roofline phase's limit: its first two runs on an NVIDIA H100 80GB
# HBM3 at 700 W took 5.4 and 8.6 s (the host's speed: the script took 842
# and 1,010 s); ~1.75x the slower (PERF.md section 6).
ROOFLINE_MAX_S = 15.0


def _class_ms(by_category: dict) -> dict:
    """A profile's device ms in the roofline's classes: library GEMMs,
    the TSM2X kernels (every category ``category`` names a kernel, the
    quantize pass and sum_partials among them) and the rest."""
    out = {"library GEMM": 0.0, "TSM2X kernels": 0.0, "elementwise": 0.0}
    for cat, ms in by_category.items():
        key = {"library GEMM": "library GEMM", "other": "elementwise"}.get(
            cat, "TSM2X kernels")
        out[key] += ms
    return out


def roofline_phase(gpu) -> None:
    """The measured half of the roofline: the serve phase's chatglm3-6b
    prefill (BATCH x PROMPT at full width and depth) and the train phase's
    step (TRAIN_LAYERS layers, PowerSGD rank 4, TRAIN_BATCH x TRAIN_SEQ in
    its microbatches), each counted again on meta tensors of the same
    shapes in a world of one (``launch/dryrun.count``: FLOPs and bytes a
    op on the card's shapes, the TSM2X calls from the dispatcher's record
    and ``perf_model``; each distinct layer counted once and multiplied,
    ``dryrun.depth_cuts``), beside the device time by class that those
    phases' ``profile`` lines took (``PROFILES``; nothing is traced
    again). A ``roofline`` line a path: ``compute_s`` (every FLOP at the
    bf16 peak, the reference's term) and ``compute_s_dtype_peaks`` (each
    product at its dtype's peak: f32 on the CUDA cores), ``memory_s``
    (every op's bytes, unfused: an upper bound), ``dominant``, the counted
    FLOPs beside ``model_flops``, the measured ms (unprofiled) and device
    busy ms, ``roofline_share`` = max(compute, memory) / device busy ms
    (and with the dtype peaks), and per class (library GEMM, TSM2X
    kernels, elementwise) the counted FLOPs and bytes (a TSM2X call's: the
    bytes its product needs, ``analyze.tsm2x_bytes``, with the kernel
    model's ``model_bytes`` beside them), the class's bound at its dtype
    peaks and the HBM rate, its measured device ms and the bound's share
    of them. The terms are the model's under the H100 data
    sheet's constants (``roofline/analyze.H100``). No card work; checked
    under ``ROOFLINE_MAX_S``."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    from repro_torch.optim import adamw, powersgd, schedule
    from repro_torch.roofline import analyze
    from repro_torch.serve import engine
    from repro_torch.train import train_step

    t_phase = time.perf_counter()
    meta = torch.device("meta")

    def tokens(*shape):
        return torch.empty(shape, dtype=torch.int64, device=meta)

    def prefill(cfg):
        prefill_step, _ = engine.make_serve_fns(cfg)
        prefill_step(model.LM(cfg, meta), {"tokens": tokens(BATCH, PROMPT)},
                     model.init_cache(cfg, BATCH, PROMPT + NEW, device=meta))

    def train(cfg):
        opt = adamw.AdamWConfig(
            lr=schedule.linear_warmup_cosine(3e-3, 20, TRAIN_STEPS),
            weight_decay=0.1)
        ps = powersgd.PowerSGDConfig(rank=4)
        lm = model.LM(cfg, meta).requires_grad_(True)
        state = {"params": lm, "opt": adamw.init(opt, lm),
                 "extra": powersgd.init(ps, lm)}
        step = train_step.make_train_step(
            cfg, opt, n_micro=cfg.microbatch,
            grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
        step(state, {k: tokens(TRAIN_BATCH, TRAIN_SEQ)
                     for k in ("tokens", "targets")})

    glm = registry.get_config("chatglm3-6b")
    glm4 = dataclasses.replace(glm, n_layers=TRAIN_LAYERS)
    paths = [("prefill", glm, prefill,
              2.0 * glm.active_param_count() * BATCH * PROMPT,
              PROFILES.get(("chatglm3-6b", "prefill"))),
             ("train step", glm4, train,
              6.0 * glm4.active_param_count() * TRAIN_BATCH * TRAIN_SEQ,
              PROFILES.get(("train", "step")))]
    for name, cfg, run, model_flops, prof in paths:
        check(prof is not None and prof["device_busy_ms"] > 0,
              f"roofline: no profile of the {name} to read")
        t0 = time.perf_counter()
        log = analyze.combine((coef, dryrun.count(run, cut)[1])
                              for coef, cut in dryrun.depth_cuts(cfg))
        count_s = time.perf_counter() - t0
        cost = analyze.cost(log)
        terms = analyze.roofline_terms(cost, analyze.collectives(log), 1)
        classes = analyze.by_class(log)
        measured = _class_ms(prof["by_category_ms"])
        busy = prof["device_busy_ms"]
        compute_dtype = sum(c["compute_s"] for c in classes.values())
        bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
        bound_dtype_ms = max(compute_dtype, terms["memory_s"]) * 1e3
        check(terms["collective_s"] == 0.0 and cost["flops"] > 0
              and all(math.isfinite(v) for v in (bound_ms, bound_dtype_ms)),
              f"roofline {name}: {terms}")
        emit({"phase": "roofline", "path": name, "model": cfg.name,
              "layers": cfg.n_layers,
              "compute_s": terms["compute_s"],
              "compute_s_dtype_peaks": compute_dtype,
              "memory_s": terms["memory_s"], "dominant": terms["dominant"],
              "counted_flops": cost["flops"], "model_flops": model_flops,
              "counted_bytes": cost["bytes accessed"],
              "measured_ms": prof["unprofiled_ms"], "device_busy_ms": busy,
              "roofline_share": bound_ms / busy,
              "roofline_share_dtype_peaks": bound_dtype_ms / busy,
              "by_class": {
                  k: {"flops": classes[k]["flops"],
                      "bytes": classes[k]["bytes"],
                      # the TSM2X kernels' modelled traffic, beside
                      # the bytes their products need
                      **({"model_bytes": classes[k]["model_bytes"]}
                         if "model_bytes" in classes[k] else {}),
                      "bound_ms": classes[k]["bound_s"] * 1e3,
                      "measured_ms": measured[k],
                      "bound_share": (classes[k]["bound_s"] * 1e3
                                      / measured[k] if measured[k] else None)}
                  for k in measured},
              "tsm2x_calls": [[e["kernel"], e["shape"], e["S"], e["body"],
                               e["n"]] for e in log.entries
                              if e["cls"] == "tsm2x"],
              "count_s": count_s,
              "terms": "model terms under H100 data-sheet constants",
              "gpu": gpu})
    secs = time.perf_counter() - t_phase
    emit({"phase": "roofline", "line": "summary", "seconds": secs,
          "limit_s": ROOFLINE_MAX_S, "gpu": gpu})
    check(secs < ROOFLINE_MAX_S, f"the roofline phase took {secs} s, over "
          f"{ROOFLINE_MAX_S}")


def contracts_phase(dev, gpu) -> None:
    """Every launch that a record scope of every path recorded (the
    dispatch path ran under ``verify_contracts=True``) against the
    contracts on this card's limits, its grid against ``launch_grid`` of
    its params and against the library's plan query, and its body against
    the query's."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import _build

    limits = contracts.card_limits(dev)
    tags = {torch.float32: "f32", torch.bfloat16: "bf16"}
    seen, per_path, bad, drift = set(), {}, [], []
    for path, events in RECORDED.items():
        per_path[path] = 0
        for e in events:
            for lm in e.launches:
                per_path[path] += 1
                p = lm.params
                key = (lm.kind, lm.shape, str(lm.dtype), lm.splits,
                       tuple(sorted((k, v % 16)
                                    for k, v in p["ptrs"].items())),
                       str(p.get("out_dtype")))
                if key in seen:
                    continue
                seen.add(key)
                if lm.kind == "reduce":
                    s, rows, cols = lm.shape
                    vios = contracts.check_grid("reduce", lm.shape, p)
                    want = contracts.launch_grid("reduce", lm.shape, p)
                    c_grid, _, c_body, _ = _build.reduce_plan(
                        s, rows, cols, tags[p["out_dtype"]], p["ptrs"]["p"],
                        p["ptrs"]["c"])
                    body = p["vec"]     # the vector width
                else:
                    kind = lm.kind.removesuffix("_q8")
                    vios = (contracts.check_kernel_config(
                        kind, lm.shape, p, lm.dtype, limits,
                        out_dtype=p.get("out_dtype"))
                        + contracts.check_grid(kind, lm.shape, p))
                    want = contracts.launch_grid(kind, lm.shape, p)
                    (c_body, c_grid), body = _c_plan(kind, lm), p["body"]
                bad.extend(dict(v.to_json(), path=path) for v in vios)
                if not (lm.grid == want == tuple(c_grid) and body == c_body):
                    drift.append({"path": path, "kind": lm.kind,
                                  "shape": lm.shape, "recorded": lm.grid,
                                  "launch_grid": want, "c_grid": c_grid,
                                  "body": body, "c_body": c_body})
    emit({"phase": "contracts", "limits": dataclasses.asdict(limits),
          "launches_checked": per_path, "distinct_launches": len(seen),
          "violations": bad, "grid_or_body_mismatches": drift, "gpu": gpu})
    check(not bad, f"contract violations on the paths: {bad[:5]}")
    check(not drift, f"grids or bodies off their statement: {drift[:5]}")
    check(all(per_path.get(p, 0) > 0 for p in (
        "dispatch", "autotune", "serve", "serve_int8", "train",
        "train_int8", "tsqr", "train_tsqr", "rwkv_serve", "rwkv_train",
        "zamba_serve", "zamba_train", "mixtral_serve", "mixtral_long",
        "mixtral_train", "deepseek_serve")),
        f"paths without recorded launches: {per_path}")


def _bounds_ms(nbytes, flops, rate) -> dict:
    return {"bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "flops_bound_ms": flops / rate * 1e3}


def bound_class_phase(dev, uniform, gpu) -> None:
    """A ``bound_class`` line: each main-path shape's class (the paper's
    section 3.1.8 on the H100's ridges) beside the kernel's device ms, its
    bytes and operations bounds, and ``torch.matmul``'s device ms."""
    from repro_torch.core import tsmm
    from repro_torch.kernels import tsm2l as k_tsm2l
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.kernels import tsmt as k_tsmt

    kerns = {"tsm2r": k_tsm2r.tsm2r, "tsm2l": k_tsm2l.tsm2l,
             "tsmt": k_tsmt.tsmt}
    rows = []
    for name, entry, (m, d1, d2), dtype in BOUND_SHAPES:
        if entry == "mm":
            x, y = uniform((m, d1), dtype), uniform((d1, d2), dtype)
            kind = tsmm.classify_gemm(m, d1, d2)
            shape, lib = (m, d1, d2), (lambda: torch.matmul(x, y))
            nbytes = (m * d1 + d1 * d2 + m * d2) * x.element_size()
        else:   # X[m,a]^T Y[m,b]: an (a, m, b) product
            x, y = uniform((m, d1), dtype), uniform((m, d2), dtype)
            kind = tsmm.classify_gemm_t(m, d1, d2)
            shape, lib = (d1, m, d2), (lambda: torch.matmul(x.t(), y))
            nbytes = (m * d1 + m * d2 + d1 * d2) * x.element_size()
        fn = (lambda k=kerns[kind]: k(x, y))
        rows.append({"shape": name, "entry": entry, "mkn": list(shape),
                     "dtype": str(dtype)[6:], "kernel": kind,
                     "class": tsmm.bound_class(*shape, dtype),
                     "device_ms": device_ms(fn, kind),
                     "call_device_ms": call_device_ms(fn),
                     **_bounds_ms(nbytes, 2 * m * d1 * d2,
                                  PEAK_FLOPS[dtype]),
                     "library_device_ms": call_device_ms(lib)})
        del x, y
    emit({"phase": "bound_class", "rows": rows, "gpu": gpu})
    check(all(r["class"] in ("memory", "compute", "latency") for r in rows),
          f"bound classes {rows}")


def threshold_sweep(dev, uniform, gpu) -> None:
    """Data for the H100 classifier thresholds, routing nothing: tsm2r
    (bf16) and tsm2r_q8 (int8 codes, bf16 out) against ``torch.matmul`` in
    bf16, device ms each, at ``THRESHOLD_SWEEP``'s shapes; beside them the
    bf16 op the dispatcher would run there as tsm2r (at the S its chooser
    resolves, with the split's epilogue), every device kernel of the
    call."""
    from repro_torch.core import perf_model, tsmm
    from repro_torch.kernels import ops, quant
    from repro_torch.kernels import tsm2r as k_tsm2r

    bf16, band = torch.bfloat16, perf_model.Q8_BAND
    ops16, ops8, libs, rows = [], [], [], []
    for m, k, n in THRESHOLD_SWEEP:
        a, b = uniform((m, k), bf16), uniform((k, n), bf16)
        kmajor = perf_model.tsm2r_body(k, n, torch.int8) == "wgmma"
        a_q, a_s = quant.quantize_blocks(a, band)
        b_q, b_s = quant.quantize_tensor(b, kmajor=kmajor)
        ops16.append(lambda a=a, b=b: k_tsm2r.tsm2r(a, b))
        ops8.append(lambda a_q=a_q, b_q=b_q, a_s=a_s, b_s=b_s:
                    k_tsm2r.tsm2r_q8(a_q, b_q, a_s, b_s, band, bf16))
        libs.append(lambda a=a, b=b: torch.matmul(a, b))
        rows.append({"mkn": [m, k, n], "route": tsmm.classify_gemm(m, k, n),
                     "class_bf16": tsmm.bound_class(m, k, n, bf16),
                     "class_int8": tsmm.bound_class(m, k, n, torch.int8),
                     "op_splits": ops.resolve_params(
                         "tsm2r", m, k, n, bf16, tsmm.GemmPolicy(),
                         device=dev)["splits"],
                     "op_device_ms": call_device_ms(
                         lambda a=a, b=b: tsmm.tsmm(a, b, mode="tsm2r"))})
    ms16 = device_ms_each(ops16, "tsm2r", reps=5)
    ms8 = device_ms_each(ops8, "tsm2r_q8", reps=5)
    for row, t16, t8, lib in zip(rows, ms16, ms8, libs):
        row.update(tsm2r_device_ms=t16, tsm2r_q8_device_ms=t8,
                   matmul_bf16_device_ms=call_device_ms(lib))
        row["tsm2r_over_matmul"] = t16 / row["matmul_bf16_device_ms"]
        row["op_over_matmul"] = (row["op_device_ms"]
                                 / row["matmul_bf16_device_ms"])
        row["tsm2r_q8_over_matmul"] = t8 / row["matmul_bf16_device_ms"]
    emit({"phase": "threshold_sweep", "rows": rows, "gpu": gpu})
    del ops16, ops8, libs
    torch.cuda.empty_cache()


def conditioned(m, r, cond, dtype, gen, dev):
    """A = U diag(logspace(0, -log10 cond)) V^T with U, V orthonormal from
    seeded normals: its 2-norm condition number is ``cond``."""
    u = torch.linalg.qr(torch.randn((m, r), generator=gen, device=dev))[0]
    v = torch.linalg.qr(torch.randn((r, r), generator=gen, device=dev))[0]
    s = torch.logspace(0, -math.log10(cond), r, device=dev)
    return ((u * s) @ v.t()).to(dtype)


def orth_err(q) -> float:
    q = q.float()
    eye = torch.eye(q.shape[1], device=q.device)
    return float((q.t() @ q - eye).abs().max())


def tsqr_phase(dev, gpu, counts, zero_counts) -> dict:
    """The tall-skinny QR (its own path: counts zeroed before, read
    after): ``linalg.tsqr`` at ``TSQR_CASES`` and conditions 1e0, 1e4,
    1e6, each held to its orthogonality bar, reconstructing A, agreeing
    with the ``mode="dense"`` arm's Q R, and launching tsm2l and a TSMT
    kernel once a pass; at the first condition its event and device ms
    beside ``torch.linalg.qr``'s, and for f32 the gradient of a weighted
    sum of Q and R against the dense arm's. Returns the path's counts:
    the factorizations' launches, not the timing loops' or the
    gradients'."""
    from repro_torch import linalg
    from repro_torch.core import tsmm

    gen = torch.Generator(device=dev).manual_seed(3)
    zero_counts()
    path = {n: 0 for n in counts()}
    for m, r, dtype in TSQR_CASES:
        f32 = dtype == torch.float32
        passes = linalg.default_passes(m, r)
        for cond in TSQR_CONDS:
            a = conditioned(m, r, cond, dtype, gen, dev)
            before = counts()
            with recorded() as log:
                q, rr = linalg.tsqr(a)
            torch.cuda.synchronize()
            grown = {n: v - before[n] for n, v in counts().items()}
            path = {n: path[n] + grown[n] for n in path}
            with tsmm.policy(mode="dense"):
                qd, rd = linalg.tsqr(a)
            af = a.float()
            rec = float(torch.linalg.norm(q.float() @ rr - af)
                        / torch.linalg.norm(af))
            arms = float((q.float() @ rr - qd.float() @ rd).abs().max()
                         / af.abs().max())
            orth, orth_tol = orth_err(q), 1e-4 if f32 else 0.05
            rec_tol = 1e-5 if f32 else 0.05
            stages = [(e.kind, [lm.kind for lm in e.launches]) for e in log]
            line = {"phase": "tsqr", "shape": [m, r], "dtype": str(dtype)[6:],
                    "cond": cond, "passes": passes, "orth_err": orth,
                    "orth_tol": orth_tol, "rec_err": rec,
                    "dense_arm_err": arms, "rec_tol": rec_tol,
                    "launches": {n: v for n, v in grown.items() if v},
                    "stages": stages,
                    "r_upper": bool((torch.tril(rr, -1) == 0).all()
                                    and (torch.diagonal(rr) >= 0).all()),
                    "gpu": gpu}
            tsmt_runs = grown["tsmt"] + grown["tsmt_split"]
            ok = (orth <= orth_tol and rec <= rec_tol and arms <= rec_tol
                  and line["r_upper"] and q.dtype == dtype
                  and grown["tsm2l"] == passes and tsmt_runs == passes
                  and all(k in ("tsmt", "tsm2l") for k, _ in stages))
            if cond == TSQR_CONDS[0]:
                line.update(
                    ms=time_ms(lambda: linalg.tsqr(a)),
                    device_ms=call_device_ms(lambda: linalg.tsqr(a)),
                    torch_qr_ms=time_ms(lambda: torch.linalg.qr(af)),
                    torch_qr_device_ms=call_device_ms(
                        lambda: torch.linalg.qr(af)))
                if f32:
                    line["grad_vs_dense"] = tsqr_grad_err(a, dev)
                    ok = ok and line["grad_vs_dense"] <= 1e-3
            line["ok"] = ok
            emit(line)
            check(ok, f"tsqr {m}x{r} {dtype} cond {cond}: {line}")
            del a, q, rr, qd, rd, af
    torch.cuda.empty_cache()
    return path


def tsqr_grad_err(a, dev) -> float:
    """Normalised distance between the gradients of sum(Q W_q) + sum(R
    W_r) through the kernels and through the ``mode="dense"`` arm."""
    from repro_torch import linalg
    from repro_torch.core import tsmm

    m, r = a.shape
    w_q = torch.cos(torch.arange(m * r, device=dev,
                                 dtype=torch.float32)).reshape(m, r)
    w_r = torch.sin(torch.arange(r * r, device=dev,
                                 dtype=torch.float32)).reshape(r, r)
    grads = []
    for mode in ("auto", "dense"):
        x = a.detach().clone().requires_grad_(True)
        with tsmm.policy(mode=mode):
            q, rr = linalg.tsqr(x)
            (torch.sum(q * w_q) + torch.sum(rr * w_r)).backward()
        grads.append(x.grad)
    return normalised_err(*grads)


def train_tsqr_phase(dev, gpu, counts, zero_counts) -> dict:
    """The train-tsqr arm (its own path): the f32-PowerSGD train
    configuration with ``PowerSGDConfig(orth="tsqr")``, TRAIN_TSQR_STEPS
    steps, each ``step_ok``, launching tsm2l once a pass for each of the
    two compressed leaves' P, a TSMT kernel for each Gram and each Q, and
    tsm2r as the train path does. Returns the path's counts."""
    import dataclasses

    from repro_torch import linalg
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw, powersgd, schedule
    from repro_torch.train import train_step

    cfg = dataclasses.replace(registry.get_config("chatglm3-6b"),
                              n_layers=TRAIN_LAYERS)
    dcfg = pipeline.DataConfig(seed=0, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH,
                               vocab_size=cfg.vocab_size)
    opt = adamw.AdamWConfig(
        lr=schedule.linear_warmup_cosine(3e-3, 20, TRAIN_STEPS),
        weight_decay=0.1)
    ps = powersgd.PowerSGDConfig(rank=4, orth="tsqr")
    state = train_step.init_train_state(0, cfg, opt, device=dev)
    state["extra"] = powersgd.init(ps, state["params"])
    leaves = len(state["extra"])
    step = train_step.make_train_step(
        cfg, opt, n_micro=cfg.microbatch,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
    per_step_tsm2r = 2 * TRAIN_LAYERS * cfg.microbatch * 2 + leaves
    passes = linalg.default_passes(cfg.vocab_size, ps.rank)   # P's rows
    want_tsm2l = leaves * passes
    want_tsmt = leaves * (1 + passes)   # Q, and each Gram
    zero_counts()
    records, step_ms = [], []
    for i in range(TRAIN_TSQR_STEPS):
        batch = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in pipeline.batch_for_step(dcfg, i).items()}
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded():
            state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grown = {n: v - before[n] for n, v in counts().items()}
        rec = {"step": i + 1, "step_ok": bool(m["step_ok"]),
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "launches": {n: v for n, v in grown.items() if v},
               "ms": step_ms[-1]}
        records.append(rec)
        check(rec["step_ok"], f"train-tsqr step {i + 1} not ok: {rec}")
        check(grown["tsm2l"] == want_tsm2l
              and grown["tsm2r"] == per_step_tsm2r
              and grown["tsmt"] + grown["tsmt_split"] == want_tsmt,
              f"train-tsqr launches in step {i + 1}: {grown}")
        del batch, m
    emit({"phase": "train-tsqr", "model": cfg.name, "layers": cfg.n_layers,
          "orth": ps.orth, "passes": passes,
          "compressed_leaves": leaves, "steps": records, "step_ms": step_ms,
          "median_step_ms": statistics.median(step_ms),
          "tsm2l_launches_per_step": want_tsm2l, "gpu": gpu})
    del state
    torch.cuda.empty_cache()
    return counts()


# ---------------------------------------------------------------------------
# The launch phase: launch/train.py at chatglm3-6b's width, with snapshot
# rollback, checkpoint escalation and resume
# ---------------------------------------------------------------------------

LAUNCH_ARCH = "chatglm3-6b-4l"
# The offline ABFT check before a save (encode_tree, then verify_tree's
# second encode) of the 4-layer state's parameters: 2 tsmt and 8
# tsmt_split launches an encode, as the abft phase's four offline encodes
# launch 8 and 32; 20 of the 30 checksummed leaves go dense.
LAUNCH_CHECK = {"tsmt": 4, "tsmt_split": 16}


@contextlib.contextmanager
def launch_timers():
    """Time what the launcher calls between its steps, by wrapping the
    module and class attributes it reaches them through (restored after):
    each step's watchdog time, the snapshot, the checkpoint's save (to
    enqueue) and wait (to durable), its read and its write into the live
    state, and the offline ABFT check (with the launches it made). Yields
    the list of records, one dict a call."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.ft import abft, watchdog
    from repro_torch.kernels import tsm2r, tsmt
    from repro_torch.train import train_step

    log = []
    swapped = []

    def wrap(owner, attr, what, sync=False, size=False, launches=False):
        real = getattr(owner, attr)

        def timed(*a, **kw):
            before = (tsm2r.launches, tsmt.launches, tsmt.split_launches)
            t0 = time.perf_counter()
            out = real(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            rec = {"what": what, "s": time.perf_counter() - t0}
            if size:
                rec["gb"] = sum(t.numel() * t.element_size()
                                for t in out.values()) / 1e9
            if launches:
                rec["launches"] = {
                    n: v - b for n, v, b in zip(
                        ("tsm2r", "tsmt", "tsmt_split"),
                        (tsm2r.launches, tsmt.launches, tsmt.split_launches),
                        before)}
            log.append(rec)
            return out
        swapped.append((owner, attr, real))
        setattr(owner, attr, timed)

    real_end = watchdog.StepWatchdog.step_end

    def step_end(self):
        out = real_end(self)
        log.append({"what": "step", "s": out["step_time_s"]})
        return out

    swapped.append((watchdog.StepWatchdog, "step_end", real_end))
    watchdog.StepWatchdog.step_end = step_end
    wrap(train_step, "host_snapshot", "snapshot", size=True)
    wrap(train_step, "restore_snapshot", "write into state", sync=True)
    wrap(Checkpointer, "restore", "checkpoint read")
    wrap(Checkpointer, "save", "save enqueue")
    wrap(Checkpointer, "wait", "save durable")
    wrap(Checkpointer, "_write", "checkpoint write")   # the writer thread
    wrap(abft, "encode_tree", "abft encode", sync=True, launches=True)
    wrap(abft, "verify_tree", "abft verify", sync=True, launches=True)
    try:
        yield log
    finally:
        for owner, attr, real in reversed(swapped):
            setattr(owner, attr, real)


def launch_phase(gpu, counts, zero_counts) -> dict:
    """The launch path: ``repro_torch.launch.train.main`` as a user runs
    it, on the card (no ``--device``), at chatglm3-6b's width with
    TRAIN_LAYERS layers (``LAUNCH_ARCH``, registered as
    ``examples/train_lm.py`` registers its config), TRAIN_BATCH x
    TRAIN_SEQ tokens and PowerSGD rank 4. Four runs, counts zeroed just
    before each and read just after: A, 3 clean steps; B, a NaN in the
    parameters before step 1, rolled back to the step-0 snapshot and
    replayed; C1, 1 step saved after the offline ABFT check; C2, resumed
    from C1's checkpoint, a NaN before step 1 with snapshots off,
    escalated to that checkpoint and replayed to step 2, saved after the
    check. B's and C2's final losses must equal A's bit for bit, each
    run must launch tsm2r 66 and tsmt 2 times a step it executed, and the
    checks LAUNCH_CHECK. Returns the path's counts."""
    import shutil
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.launch import train as launcher

    cfg = dataclasses.replace(registry.get_config("chatglm3-6b"),
                              name=LAUNCH_ARCH, n_layers=TRAIN_LAYERS)
    registry._MODULES[LAUNCH_ARCH] = type(
        "M", (), {"CONFIG": cfg, "smoke": staticmethod(lambda: cfg)})
    per_step = {"tsm2r": 2 * TRAIN_LAYERS * cfg.microbatch * 2 + 2,
                "tsmt": 2}
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    meminfo = dict(line.split(":", 1) for line in
                   Path("/proc/meminfo").read_text().splitlines())
    emit({"phase": "launch", "arch": LAUNCH_ARCH, "layers": cfg.n_layers,
          "mem_available_gb": int(meminfo["MemAvailable"].split()[0])
          * 1024 / 1e9, "tmp": ckpt_dir,
          "tmp_free_gb": shutil.disk_usage(ckpt_dir).free / 1e9,
          "gpu": gpu})
    base = ["--arch", LAUNCH_ARCH, "--global-batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--powersgd-rank", "4",
            "--log-every", "1"]
    runs = {
        "A": ["--steps", "3"],
        "B": ["--steps", "3", "--chaos-step", "1"],
        "C1": ["--steps", "1", "--ckpt-dir", ckpt_dir, "--ckpt-every", "1",
               "--abft-every", "2"],
        "C2": ["--steps", "3", "--ckpt-dir", ckpt_dir, "--ckpt-every", "2",
               "--snapshot-every", "0", "--chaos-step", "1",
               "--abft-every", "2"],
    }
    want_checks = {"A": 0, "B": 0, "C1": 1, "C2": 1}
    total = {n: 0 for n in counts()}
    out = {}
    try:
        for tag, extra in runs.items():
            torch.cuda.empty_cache()
            zero_counts()
            t0 = time.perf_counter()
            with launch_timers() as log, recorded():
                res = launcher.main(base + extra)
            wall = time.perf_counter() - t0
            launches = counts()
            for n, v in launches.items():
                total[n] += v
            steps = [r["s"] * 1e3 for r in log if r["what"] == "step"]
            checks = [r for r in log if r["what"].startswith("abft")]
            check_launches = {n: sum(r["launches"][n] for r in checks)
                              for n in ("tsm2r", "tsmt", "tsmt_split")}
            want = {n: 0 for n in launches}
            want["tsm2r"] = per_step["tsm2r"] * len(steps)
            want["tsmt"] = per_step["tsmt"] * len(steps)
            for n, v in (LAUNCH_CHECK if want_checks[tag] else {}).items():
                want[n] += v
            rec = {"phase": "launch", "run": tag, "argv": base + extra,
                   "result": res, "steps_executed": len(steps),
                   "step_ms": steps, "wall_s": wall,
                   "offline_check_launches": check_launches,
                   "launches": {n: v for n, v in launches.items() if v},
                   "gpu": gpu}
            emit(rec)     # its calls' times follow, one line a quantity
            out[tag] = {**rec, "calls": [r for r in log
                                         if r["what"] != "step"]}
            check(math.isfinite(res["final_loss"]),
                  f"launch run {tag}: final loss {res['final_loss']}")
            check(launches == want, f"launch run {tag} launches {launches}"
                  f", want {want}")
            check(len(checks) == 2 * want_checks[tag]
                  and check_launches["tsm2r"] == 0,
                  f"launch run {tag}: offline checks {checks}")
        faulted = {"A": (0, 0, 3), "B": (1, 1, 4), "C1": (0, 0, 1),
                   "C2": (1, 1, 3)}
        for tag, (events, retries, executed) in faulted.items():
            res = out[tag]["result"]
            check((res["fault_events"], res["fault_retries"],
                   out[tag]["steps_executed"]) == (events, retries, executed),
                  f"launch run {tag}: {res}, executed "
                  f"{out[tag]['steps_executed']}")
        LAUNCH_LOSS.update({t: r["result"]["final_loss"]
                            for t, r in out.items()},
                           step_ms={t: r["step_ms"] for t, r in out.items()})
        for tag in ("B", "C2"):
            check(out[tag]["result"]["final_loss"]
                  == out["A"]["result"]["final_loss"],
                  f"launch run {tag} final loss "
                  f"{out[tag]['result']['final_loss']!r} is not A's "
                  f"{out['A']['result']['final_loss']!r}")
        # One line a quantity, each run's calls in order.
        def calls(*whats):
            return {t: [{k: v for k, v in c.items() if k != "launches"}
                        for c in r["calls"] if c["what"] in whats]
                    for t, r in out.items()}

        emit({"phase": "launch", "line": "step_ms",
              "runs": {t: r["step_ms"] for t, r in out.items()},
              "median": {t: statistics.median(r["step_ms"])
                         for t, r in out.items()},
              "train_phase_median_step_ms": MEDIAN_STEP_MS.get("train"),
              "gpu": gpu})
        emit({"phase": "launch", "line": "snapshot",
              "runs": calls("snapshot"), "gpu": gpu})
        emit({"phase": "launch", "line": "save",
              "runs": calls("save enqueue", "checkpoint write",
                            "save durable"), "gpu": gpu})
        emit({"phase": "launch", "line": "restore",
              "runs": calls("checkpoint read", "write into state"),
              "gpu": gpu})
        emit({"phase": "launch", "line": "offline_check",
              "runs": {t: [{"what": c["what"], "ms": c["s"] * 1e3,
                            "launches": c["launches"]}
                           for c in r["calls"]
                           if c["what"].startswith("abft")]
                       for t, r in out.items()}, "gpu": gpu})
        emit({"phase": "launch", "line": "summary",
              "final_loss": {t: r["result"]["final_loss"]
                             for t, r in out.items()},
              "bit_equal_to_A": {t: out[t]["result"]["final_loss"]
                                 == out["A"]["result"]["final_loss"]
                                 for t in ("B", "C2")},
              "wall_s": {t: r["wall_s"] for t, r in out.items()},
              "launches": {n: v for n, v in total.items() if v},
              "gpu": gpu})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        registry._MODULES.pop(LAUNCH_ARCH, None)
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# rwkv6-1.6b served and trained at its published width and depth
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-1.6b"
# A rwkv-train step's launches: tsm2r at the decay LoRA's down projection
# twice a layer and microbatch (forward and remat recompute, 2 x 24 x 4)
# and P of embed and lm_head at S = 1; the one-launch tsmt at Q of both.
RWKV_TRAIN_LAUNCHES = {"tsm2r": 194, "tsmt": 2}
# Zeroing every LoRA's b must move the prefill logits LORA_X times as far
# from the kernel arm as the dense arm sits, and past LOGIT_TOL.
LORA_X = 10.0


@torch.no_grad()
def rwkv_perturb_(params, cfg, gen) -> None:
    """Give the rwkv6 leaves that start constant values drawn from
    ``gen``, in place (``RWKV_B_SCALE``): the LoRA's ``b``, ``u`` and
    ``w0`` of every layer."""
    scale = RWKV_B_SCALE * cfg.rwkv.decay_lora_rank ** -0.5
    for lp in params.layers:
        tm = lp.time_mix
        for t, sd in ((tm.w_lora.b, scale), (tm.u, 0.1), (tm.w0, 0.5)):
            draw = torch.randn(t.shape, generator=gen, device=t.device) * sd
            t.copy_(t + draw if t is tm.w0 else draw)


def split_rows(dev, uniform, gpu, shapes, dtype, tag, splits=None) -> list:
    """tsm2r_split at ``shapes`` in ``dtype``, at the S the chooser
    resolves on this card (``splits[shape]`` where given, else past 1; no
    sum_partials planned), against its plain f32 partials at the f32
    tolerance, bit-identical on a second launch, on the skinny body; its
    device time beside ``torch.matmul``'s, the bound, the sequential
    kernel and the whole op (split plus the plain sum). ``tag`` marks
    each record ("zamba": zamba-train's P; "moe": mixtral's router).
    Returns one record a shape."""
    from repro_torch.core import perf_model, tsmm
    from repro_torch.kernels import ops, ref, reduce
    from repro_torch.kernels import tsm2r as k_tsm2r

    rows = []
    for m, k, n in shapes:
        x, y = uniform((m, k), dtype), uniform((k, n), dtype)
        res = ops.resolve_params("tsm2r", m, k, n, dtype,
                                 tsmm.GemmPolicy(), device=dev)
        S, block = res["splits"], res["block_k"]
        got = k_tsm2r.tsm2r_split(x, y, S, block)
        again = k_tsm2r.tsm2r_split(x, y, S, block)
        torch.cuda.synchronize()
        want = ref.tsm2r_split_ref(x, y, S, block)
        rtol, atol = TOL[torch.float32]
        atol *= max(1.0, (ref.split_len(k, S, block) / 1024) ** 0.5)
        err = (got - want).abs()
        same = torch.equal(got, again)
        body, grid = k_tsm2r.split_plan(x, y, S, block)
        ok = (same and bool((err <= atol + rtol * want.abs()).all())
              and body == "skinny"
              and (S == splits[(m, k, n)] if splits else S > 1)
              and not perf_model.reduce_kernel_runs(S, m, n))
        b_ms, b_by = bound(x, y, got, 2 * m * k * n)
        rec = {"phase": "kernel", "kernel": "tsm2r_split", tag: True,
               "shape": [m, k, n], "splits": S, "block_k": block,
               "dtype": str(dtype)[6:], "body": body, "grid": grid,
               "kernel_ms": time_ms(lambda: k_tsm2r.tsm2r_split(
                   x, y, S, block)),
               "op_ms": time_ms(lambda: reduce.reduce_partials(
                   k_tsm2r.tsm2r_split(x, y, S, block), dtype)[0]),
               "seq_ms": time_ms(lambda: k_tsm2r.tsm2r(x, y)),
               "plain_ms": time_ms(lambda: ref.tsm2r_split_ref(x, y, S,
                                                               block)),
               "library_ms": time_ms(lambda: torch.matmul(x, y)),
               "device_ms": device_ms(lambda: k_tsm2r.tsm2r_split(
                   x, y, S, block), "tsm2r_split"),
               "seq_device_ms": device_ms(lambda: k_tsm2r.tsm2r(x, y),
                                          "tsm2r"),
               "library_device_ms": call_device_ms(
                   lambda: torch.matmul(x, y)),
               "bound_ms": b_ms, "bound_by": b_by,
               "max_err": float(err.max()), "rtol": rtol, "atol": atol,
               "deterministic": same, "ok": ok, "gpu": gpu}
        emit(rec)
        check(ok, f"tsm2r_split at {tag}'s {rec}")
        rows.append(rec)
        del x, y, got, again, want, err
    torch.cuda.empty_cache()
    return rows


@torch.no_grad()
def zamba_perturb_(params, cfg, gen) -> None:
    """Draw both shared LoRAs' ``b`` of every group from ``gen``, in place
    (``ZAMBA_B_SCALE``)."""
    scale = ZAMBA_B_SCALE * cfg.shared_lora_rank ** -0.5
    for group in params.groups:
        for lora in (group.lora_attn, group.lora_ffn):
            lora.b.copy_(torch.randn(lora.b.shape, generator=gen,
                                     device=lora.b.device) * scale)


def zamba_decode_gemms(cfg) -> int:
    """The projections of one zamba2 decode step, every one dense at 4
    rows: in_proj and out_proj of each Mamba2 layer; per application of
    the shared block wq, wk, wv, wo, the FFN's three and both LoRAs' a
    and b."""
    return 2 * cfg.n_layers + 11 * (cfg.n_layers // cfg.hybrid_period)


@torch.no_grad()
def decode_and_forward(params, cfg, prompts, out, tail, dev, extras=None):
    """A prefill of ``prompts`` (and ``extras``), cached decode of
    ``out``'s first NEW - 1 tokens, and the teacher-forced forward of the
    prompt, ``out`` and ``tail``. Returns (the logits of every step, the
    forward's logits at the NEW positions)."""
    from repro_torch.models import model

    extras = extras or {}
    cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    logits, cache = model.prefill(params, cfg,
                                  {"tokens": prompts, **extras}, cache)
    steps = [logits]
    for i in range(1, NEW):
        logits, cache = model.decode_step(params, cfg, out[:, i - 1:i],
                                          PROMPT + i - 1, cache)
        steps.append(logits)
    del cache
    forced, _ = model.forward(
        params, cfg, {"tokens": torch.cat([prompts, out, tail], dim=1),
                      **extras})
    rows = forced[:, PROMPT - 1:PROMPT - 1 + NEW].clone()
    del forced
    torch.cuda.empty_cache()
    return steps, rows


def max_step_err(steps, rows) -> float:
    """The largest normalised error of a step's logits against ``rows``'
    at its position."""
    return max(normalised_err(steps[i], rows[:, i]) for i in range(NEW))


@torch.no_grad()
def f32_copy(params, cfg, dev):
    """The model's weights in f32 (``load_state_dict`` casts each leaf)."""
    from repro_torch.models import model

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = model.LM(cfg32, device=dev)
    p32.load_state_dict(params.state_dict())
    return p32, cfg32


def zamba_cut(params, cfg, groups):
    """The served zamba2 model cut to its first ``groups`` groups and its
    tail: the same tensors (no copy), the same shared block."""
    from repro_torch.models import model

    cut_cfg = dataclasses.replace(
        cfg, n_layers=groups * cfg.hybrid_period + len(params.tail))
    cut = model.LM(cut_cfg, device="meta")
    cut.load_state_dict({k: v for k, v in params.state_dict().items()
                         if not k.startswith("groups.")
                         or int(k.split(".")[1]) < groups}, assign=True)
    return cut, cut_cfg


def zamba_depth_rung(params, cfg, prompts, out, tail, dev, bf16=None):
    """One rung of the depth ladder: cached decode against the
    teacher-forced forward in bf16 and in an f32 copy of the same
    weights, and the bf16 forward's and decode's distance from the f32
    forward. ``bf16``: the bf16 (steps, rows) if already taken."""
    steps, rows = bf16 or decode_and_forward(params, cfg, prompts, out,
                                             tail, dev)
    p32, cfg32 = f32_copy(params, cfg, dev)
    steps32, exact = decode_and_forward(p32, cfg32, prompts, out, tail, dev)
    del p32
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers,
            "groups": cfg.n_layers // cfg.hybrid_period,
            "decode_vs_forward_err": max_step_err(steps, rows),
            "forward_vs_f32_err": max_step_err(
                [rows[:, i] for i in range(NEW)], exact),
            "decode_vs_f32_err": max_step_err(steps, exact),
            "f32_decode_vs_forward_err": max_step_err(steps32, exact)}


def teacher_forced(mp, params, cfg, prompts, out, gen, dev, extras=None):
    """The teacher-forced forward of the prompt, ``out`` and a tail drawn
    from ``gen``, ``mp.forced`` tokens a request (with ``extras`` in its
    batch); it launches tsm2r once at each of the prefill's shapes.
    Returns (its logits at the NEW positions the cached steps predict, the
    tail)."""
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.models import model

    tail = torch.randint(0, cfg.vocab_size,
                         (BATCH, mp.forced - PROMPT - NEW),
                         generator=gen, device=dev)
    before = k_tsm2r.launches
    with torch.no_grad():
        forced, _ = model.forward(
            params, cfg, {"tokens": torch.cat([prompts, out, tail], dim=1),
                          **(extras or {})})
    check(k_tsm2r.launches - before == len(mp.prefill_shapes(
        cfg, BATCH * mp.forced)), f"{mp.tag} forward launches")
    rows = forced[:, PROMPT - 1:PROMPT - 1 + NEW].clone()
    del forced
    torch.cuda.empty_cache()
    return rows, tail


def zamba_decode_check(mp, params, cfg, prompts, out, step_logits, gen,
                       dev, extras=None) -> dict:
    """zamba-serve's cached decode against the teacher-forced forward
    (``teacher_forced``), on a ladder of depths (``ZAMBA_LADDER``: the
    model cut to its first groups and its tail, then whole). At every
    rung: the f32 copy's decode within ``ZAMBA_F32_TOL`` of its forward
    (the cache's logic); the bf16 decode no further from the f32 forward
    than ``ZAMBA_FLOOR_X`` times the bf16 forward is, and no further from
    the bf16 forward than that forward is from f32 (the cache's bf16
    numerics, against the rounding floor of that depth). Returns the
    rungs."""
    rows, tail = teacher_forced(mp, params, cfg, prompts, out, gen, dev)
    rec = {"forced_tokens": mp.forced,
           "decode_vs_forward_err": max_step_err(step_logits, rows)}
    ladder = []
    for groups in ZAMBA_LADDER:
        cut, cut_cfg = zamba_cut(params, cfg, groups)
        ladder.append(zamba_depth_rung(cut, cut_cfg, prompts, out, tail,
                                       dev))
        del cut
    ladder.append(zamba_depth_rung(params, cfg, prompts, out, tail, dev,
                                   bf16=(step_logits, rows)))
    emit({"phase": "zamba-ladder", "rungs": ladder})
    for rung in ladder:
        check(rung["f32_decode_vs_forward_err"] <= ZAMBA_F32_TOL,
              f"zamba f32 decode vs forward at {rung}")
        floor = rung["forward_vs_f32_err"]
        check(rung["decode_vs_f32_err"] <= ZAMBA_FLOOR_X * floor
              and rung["decode_vs_forward_err"] <= floor,
              f"zamba bf16 decode against the forward at {rung}")
    return {**rec, "ladder": ladder}


def rwkv_decode_check(mp, params, cfg, prompts, out, step_logits, gen,
                      dev, extras=None) -> dict:
    """rwkv-serve's cached decode within ``LOGIT_TOL`` of the
    teacher-forced forward (``teacher_forced``)."""
    rows, _ = teacher_forced(mp, params, cfg, prompts, out, gen, dev)
    err = max_step_err(step_logits, rows)
    check(err <= LOGIT_TOL, f"rwkv decode vs forward error {err}")
    return {"forced_tokens": mp.forced, "decode_vs_forward_err": err}


def zeroed(leaves):
    """A ``ModelPath.reach`` that zeroes, in place, every tensor that
    ``leaves(params, cfg)`` gives; it returns the undo."""
    @torch.no_grad()
    def reach(params, cfg):
        saved = [(t, t.clone()) for t in leaves(params, cfg)]
        for t, _ in saved:
            t.zero_()

        @torch.no_grad()
        def undo():
            for t, v in saved:
                t.copy_(v)
        return undo
    return reach


@contextlib.contextmanager
def moe_taps(pin=None):
    """Each MoE layer call's expert ids (T, k) and metrics, in call order,
    read from ``models.moe`` while the scope is open. ``pin``: call number
    -> the expert ids that call takes in place of its own choice, weighted
    by the call's own probabilities at them, renormalised (the ids tapped
    stay the call's own choice)."""
    from repro_torch.models import moe

    routes, metrics = [], []
    route, fwd = moe.route, moe.moe_fwd

    def tapped_route(p, xt, cfg):
        w, idx, probs = route(p, xt, cfg)
        routes.append(idx)
        if pin is not None:
            idx = pin(len(routes) - 1)
            w = torch.gather(probs, 1, idx)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w, idx, probs

    def tapped_fwd(p, x, cfg):
        out, met = fwd(p, x, cfg)
        metrics.append({k: float(v) for k, v in met.items()})
        return out, met

    moe.route, moe.moe_fwd = tapped_route, tapped_fwd
    try:
        yield routes, metrics
    finally:
        moe.route, moe.moe_fwd = route, fwd


def experts(ids):
    """Expert ids as sets: sorted along k."""
    return torch.sort(ids, dim=-1).values


def route_flips(a, b) -> int:
    """(token, layer) routes whose expert sets differ between two arms."""
    return sum(int((experts(x) != experts(y)).any(-1).sum())
               for x, y in zip(a, b))


def router_launches(shapes, dtype, dev) -> dict:
    """The launches the dispatcher makes for tsm2r products at ``shapes``:
    the chooser's S on this card picks tsm2r or tsm2r_split (and
    sum_partials where the split's epilogue runs it). Returns (launches,
    {shape: S})."""
    from repro_torch.core import perf_model, tsmm
    from repro_torch.kernels import ops

    want, splits = {}, {}
    for m, k, n in shapes:
        s = ops.resolve_params("tsm2r", m, k, n, dtype, tsmm.GemmPolicy(),
                               device=dev)["splits"]
        splits[(m, k, n)] = s
        kern = "tsm2r" if s == 1 else "tsm2r_split"
        want[kern] = want.get(kern, 0) + 1
        if s > 1 and perf_model.reduce_kernel_runs(s, m, n):
            want["sum_partials"] = want.get("sum_partials", 0) + 1
    return want, splits


def prefill_route_check(name, log, shapes, splits, body, rows) -> list:
    """A prefill's routed events: tsm2r on the card at ``shapes``, each at
    the chooser's S on ``body`` (none where ``shapes`` is empty). Returns
    the bodies seen."""
    routed = [e for e in log if e.kind != "dense" and e.shape[0] == rows]
    metas = [(e, lm) for e in routed for lm in e.launches
             if lm.kind != "reduce"]
    bodies = sorted({lm.params["body"] for _, lm in metas})
    check(sorted(e.shape for e in routed) == sorted(shapes)
          and bodies == ([body] if shapes else []) and all(
              e.kind == "tsm2r" and e.executor == "cuda"
              and lm.splits == splits[e.shape] for e, lm in metas),
          f"{name} prefill routes {routed[:2]} {bodies}")
    return bodies


class ModelPath(typing.NamedTuple):
    """What a model's serve and train phases take from it."""
    tag: str                 # the phases are "<tag>-serve", "<tag>-train"
    arch: str                # the registered config
    perturb: object          # (params, cfg, gen): draws the constant leaves
    prefill_shapes: object   # (cfg, rows) -> tsm2r's shapes a prefill
    decode_gemms: object     # cfg -> dense projections a decode step
    reach: object            # (params, cfg) -> undo: a change that the
    reach_what: str          # logits must feel, and what it is
    decode_check: object     # holds cached decode against the forward
                             # (given the batch's extras too)
    forced: int = 0          # tokens of ``teacher_forced``'s forward
    body: str = "wgmma"      # tsm2r's body at the prefill's shapes
    n_micro: int = 0         # the config's microbatches
    micro_downs: object = None   # cfg -> tsm2r a train microbatch
    leaves: tuple = ()       # the leaves PowerSGD compresses
    train_launches: dict = None  # a step's launches
    encoder: bool = False    # served by forward and prefill of frames
    images: object = None    # (cfg, gen, dev) -> the batch's image
                             # embeddings beside its tokens
    limit_s: float = 0.0     # a limit on each phase's seconds (0: none)


RWKV_PATH = ModelPath(
    tag="rwkv", arch=RWKV_ARCH, perturb=rwkv_perturb_,
    # the decay LoRA's down projection in every layer
    prefill_shapes=lambda cfg, rows: [
        (rows, cfg.d_model, cfg.rwkv.decay_lora_rank)] * cfg.n_layers,
    # wr, wk, wv, wg, the LoRA's a and b, wo; the channel mix's wk, wv, wr
    decode_gemms=lambda cfg: 10 * cfg.n_layers,
    reach=zeroed(lambda p, cfg: [lp.time_mix.w_lora.b for lp in p.layers]),
    reach_what="every decay LoRA's b zeroed",
    decode_check=rwkv_decode_check,
    # the prompt and every generated token (the last logits go unused):
    # the chunk rule takes chunks of 24
    forced=PROMPT + NEW, n_micro=4,
    # forward and remat recompute; the up projection is dense, and a dense
    # product's backward is autograd's, so its dh = dy b^T reaches no kernel
    micro_downs=lambda cfg: 2 * cfg.n_layers,
    leaves=("embed.table", "lm_head.table"),
    train_launches=RWKV_TRAIN_LAUNCHES)
ZAMBA_PATH = ModelPath(
    tag="zamba", arch=ZAMBA_ARCH, perturb=zamba_perturb_,
    # the attention and FFN LoRAs' down projection of every group
    prefill_shapes=lambda cfg, rows: [
        (rows, cfg.d_model, cfg.shared_lora_rank)] * (
            2 * (cfg.n_layers // cfg.hybrid_period)),
    decode_gemms=zamba_decode_gemms,
    reach=zeroed(lambda p, cfg: [lo.b for g in p.groups
                                 for lo in (g.lora_attn, g.lora_ffn)]),
    reach_what="every shared LoRA's b zeroed",
    decode_check=zamba_decode_check, forced=ZAMBA_FORCED, n_micro=8,
    # the attention and FFN LoRAs of every group; the shared block is not
    # checkpointed, so no recompute
    micro_downs=lambda cfg: 2 * (cfg.n_layers // cfg.hybrid_period),
    leaves=("embed.table", "lm_head.table", *(f"shared_block.{k}" for k in (
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.w_gate",
        "ffn.w_up", "ffn.w_down"))),
    train_launches=ZAMBA_TRAIN_LAUNCHES)


def model_serve_phase(mp, dev, gpu, counts, zero_counts, expect,
                      keep: bool = False) -> tuple:
    """A model's serve path (``mp``: ``RWKV_PATH``, ``ZAMBA_PATH``,
    ``MIXTRAL_PATH``, ``DEEPSEEK_PATH``, ``VISION_PATH``) at published
    width and its registered depth, bf16, seeded weights perturbed by
    ``mp.perturb``; 4 x 2048 prompt tokens (each request with its own
    image embeddings from ``mp.images`` where the model reads them) and 16
    greedy tokens, a sampled run, then step by step for times (the counts
    are read there). Each prefill launches,
    at ``mp.prefill_shapes``, what the chooser on this card resolves
    (tsm2r, or tsm2r_split at S > 1) on ``mp.body``; every decode GEMM is
    dense. Then the checks: the prefill against a ``mode="dense"`` arm
    within ``LOGIT_TOL`` (the (token, layer) routes that flip between the
    arms counted), ``mp.reach`` must move the logits past ``LOGIT_TOL``
    and ``LORA_X`` times as far as the dense arm sits, and cached decode
    against a teacher-forced forward (``mp.decode_check``); an MoE
    model's drops and largest loads at the config's capacity in the
    prefill; a profiled prefill. ``keep`` puts the run's ``serve_ref``
    into ``SERVE_REF`` under ``mp.tag``, for the mesh phases to hold their
    runs against. The phase must end within ``mp.limit_s`` where it is
    set. Returns (the path's launch counts, the parameters, the
    config)."""
    from repro_torch.core import tsmm
    from repro_torch.models import model
    from repro_torch.serve import engine

    name = f"{mp.tag}-serve"
    t_phase = time.perf_counter()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg, gen = serve_weights(mp, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    extras = mp.images(cfg, gen, dev) if mp.images else {}
    shapes = mp.prefill_shapes(cfg, BATCH * PROMPT)
    per_prefill, splits = router_launches(shapes, torch.bfloat16, dev)

    with recorded() as log:
        t0 = time.perf_counter()
        out = engine.generate(params, cfg, prompts, NEW, extras=extras,
                              device=dev)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    bodies = prefill_route_check(name, log, shapes, splits, mp.body,
                                 BATCH * PROMPT)
    decode_events = [e for e in log if e.shape[0] == BATCH]
    check(len(decode_events) == (NEW - 1) * mp.decode_gemms(cfg) and all(
        e.executor == "torch-dense" for e in decode_events),
        f"every {name} decode projection goes to torch-dense: "
        f"{len(decode_events)}")
    check(out.shape == (BATCH, NEW), f"greedy output shape {out.shape}")
    sampler = torch.Generator(device=dev).manual_seed(2)
    sampled = engine.generate(params, cfg, prompts, NEW, generator=sampler,
                              temperature=1.0, extras=extras, device=dev)
    check(sampled.shape == (BATCH, NEW) and bool(
        ((sampled >= 0) & (sampled < cfg.vocab_size)).all()),
        f"{name} sampled tokens in vocabulary")

    step_logits, prefill_ms, decode_ms = serve_step_by_step(
        params, cfg, prompts, out, dev, sum(per_prefill.values()), counts,
        extras)
    # The main path ends here; what follows only checks it.
    launches = counts()
    check(launches == expect(**{k: 3 * v for k, v in per_prefill.items()}),
          f"{name} path launches {launches}")
    if keep:
        SERVE_REF[mp.tag] = serve_ref(prompts, out, sampled, step_logits,
                                      prefill_ms, decode_ms, extras)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    def tapped_prefill(policy=None):
        prefill = engine.make_serve_fns(cfg, policy=policy)[0]
        with moe_taps() as (routes, mets), recorded() as plog:
            logits, _ = prefill(params, {"tokens": prompts, **extras},
                                model.init_cache(cfg, BATCH, PROMPT,
                                                 device=dev))
        return logits, routes, mets, plog

    k_logits, k_routes, k_mets, _ = tapped_prefill()
    d_logits, d_routes, _, dlog = tapped_prefill(
        tsmm.GemmPolicy(mode="dense"))
    check(all(e.executor == "torch-dense" for e in dlog),
          f"{name} dense arm routes")
    flips = route_flips(k_routes, d_routes)
    dense_err = normalised_err(step_logits[0], d_logits)
    tapped_err = normalised_err(k_logits, step_logits[0])
    check(dense_err <= LOGIT_TOL,
          f"{name} kernel vs dense arm {dense_err} ({flips} routes flip)")
    del k_logits, d_logits, k_routes, d_routes
    undo = mp.reach(params, cfg)
    moved, _ = engine.make_serve_fns(cfg)[0](
        params, {"tokens": prompts, **extras},
        model.init_cache(cfg, BATCH, PROMPT, device=dev))
    undo()
    reach_err = normalised_err(moved, step_logits[0])
    check(reach_err > LOGIT_TOL and reach_err >= LORA_X * dense_err,
          f"{name}: {mp.reach_what} moves the logits by {reach_err}: not "
          f"{LORA_X}x the dense arm's {dense_err} and past {LOGIT_TOL}")
    del moved
    greedy_agree = sum(int((torch.argmax(step_logits[i], -1) == out[:, i])
                           .sum()) for i in range(NEW))
    decode = mp.decode_check(mp, params, cfg, prompts, out, step_logits,
                             gen, dev, extras)
    torch.cuda.empty_cache()
    profile_serve(engine, model, params, cfg, prompts, out, dev,
                  {"prefill": prefill_ms, "decode": 2 * decode_ms}, gpu,
                  extras)
    moe = {"moe_layers": len(k_mets),
           "capacity_factor": cfg.moe.capacity_factor,
           "prefill_slots": capacity(cfg, BATCH * PROMPT),
           "prefill_moe": k_mets, "route_flips_vs_dense": flips,
           "routes": len(k_mets) * BATCH * PROMPT} if k_mets else {}
    emit({"phase": name, "model": cfg.name, "params": n_params,
          "dtype": cfg.dtype, "layers": cfg.n_layers, "batch": BATCH,
          "prompt": PROMPT, "new": NEW, "init_s": init_s,
          "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": BATCH * PROMPT / prefill_ms * 1e3,
          "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": BATCH / decode_ms * 1e3,
          "greedy_request_s": greedy_s,
          "launches_per_prefill": per_prefill,
          "tsm2r_shapes": sorted(set(shapes)),
          "splits": {str(list(k)): v for k, v in splits.items()},
          "tsm2r_body": bodies, "dense_arm_err": dense_err, **moe,
          "tapped_vs_served_err": tapped_err,
          "reach": mp.reach_what, "reach_err": reach_err, **decode,
          "greedy_argmax_agree": f"{greedy_agree}/{BATCH * NEW}",
          "images": {k: list(v.shape) for k, v in extras.items()},
          "peak_mem_gb": peak_gb, "launches": launches,
          "wall_s": time.perf_counter() - t_phase,
          "limit_s": mp.limit_s or None, "gpu": gpu})
    del prompts, out, step_logits, extras
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    check(not mp.limit_s or wall < mp.limit_s,
          f"{name} took {wall} s, over {mp.limit_s}")
    return launches, params, cfg


def train_prediction(mp, cfg, shapes, ps, tokens, dev) -> tuple:
    """What a train step of ``mp`` at ``cfg`` launches, as the classifier
    and the chooser on this card predict it: tsm2r (or tsm2r_split at the
    chooser's S) ``mp.micro_downs`` times a microbatch at the down
    projection, and P and Q of every compressed leaf (``shapes``: path ->
    (d1, d2)) that does not classify dense, at the chooser's S. Returns
    (launches, the factors, the down projection's shape, its S, its
    launches a step)."""
    from repro_torch.core import perf_model, tsmm
    from repro_torch.kernels import ops

    n_micro = cfg.microbatch
    downs = set(mp.prefill_shapes(cfg, tokens // n_micro))
    pol = tsmm.GemmPolicy()
    per_step_down = mp.micro_downs(cfg) * n_micro
    want, down, s_down = {}, None, 1     # hubert: no down projection
    if downs:
        down, = downs
        s_down = ops.resolve_params("tsm2r", *down,
                                    getattr(torch, cfg.dtype), pol,
                                    device=dev)["splits"]
        want = {"tsm2r" if s_down == 1 else "tsm2r_split": per_step_down}
        if s_down > 1 and perf_model.reduce_kernel_runs(s_down, down[0],
                                                        down[2]):
            want["sum_partials"] = per_step_down
    factors = []
    for path, (d1, d2) in shapes.items():
        for entry, kind, classify in (("mm", "tsm2r", tsmm.classify_gemm),
                                      ("mmt", "tsmt", tsmm.classify_gemm_t)):
            if classify(d1, d2, ps.rank, pol) == "dense":
                continue
            s = ops.resolve_params(kind, d1, d2, ps.rank, torch.float32, pol,
                                   device=dev)["splits"]
            kern = kind if s == 1 else f"{kind}_split"
            want[kern] = want.get(kern, 0) + 1
            rows = d1 if kind == "tsm2r" else d2
            if s > 1 and perf_model.reduce_kernel_runs(s, rows, ps.rank):
                want["sum_partials"] = want.get("sum_partials", 0) + 1
            factors.append({"leaf": path, "entry": entry, "kind": kern,
                            "shape": (d1, d2, ps.rank), "splits": s})
    return want, factors, down, s_down, per_step_down


def train_step_routes(what, log, mp, down, s_down, per_step_down,
                      factors) -> list:
    """A train step's routed events against :func:`train_prediction`: the
    down projections on the card on ``mp.body`` at S = ``s_down``, and P
    and Q of every factor at its S, P on the skinny body. Returns P's
    bodies."""
    kern = [e for e in log if e.kind != "dense"]
    downs = [e for e in kern if e.shape == down]
    factor_ev = [(e.entry, e.shape, lm) for e in kern if e.shape != down
                 for lm in e.launches if lm.kind != "reduce"]
    p_bodies = sorted({lm.params["body"] for entry, _, lm in factor_ev
                       if entry == "mm"})
    check(len(downs) == per_step_down and all(
        e.kind == "tsm2r" and e.executor == "cuda"
        and lm.params["body"] == mp.body
        for e in downs for lm in e.launches if lm.kind != "reduce")
        and all(lm.splits == s_down for e in downs
                for lm in e.launches if lm.kind != "reduce"),
        f"{what} down-projection routes: {downs[:2]}")
    p_routed = any(f["entry"] == "mm" for f in factors)
    check(sorted((entry, shape, lm.splits) for entry, shape, lm
                 in factor_ev) == sorted(
                     (f["entry"], f["shape"], f["splits"])
                     for f in factors)
          and p_bodies == (["skinny"] if p_routed else []),
          f"{what} P/Q routes: {factor_ev[:4]} {p_bodies}")
    return p_bodies


def model_train_phase(mp, dev, gpu, counts, zero_counts, expect) -> dict:
    """A model's train path (``mp``) at full width (and the depth its
    registered config has), bf16 parameters from seed 0 perturbed by
    ``mp.perturb``, PowerSGD rank 4, 8 x 2048 tokens in the config's
    ``mp.n_micro`` microbatches, remat on, 3 steps. Every step must be
    ``step_ok`` with a finite loss and grad norm (an MoE model's balance
    term included; its metrics are kept a step), compress exactly
    ``mp.leaves``, and launch what the classifier and the chooser on this
    card predict, which must be ``mp.train_launches``: tsm2r
    ``mp.micro_downs`` a microbatch at the down projection (a LoRA's, a
    router's: ``mp.prefill_shapes`` at a microbatch's rows) on
    ``mp.body``, and P and Q of every
    compressed leaf that does not classify dense at the chooser's S (P on
    the skinny body). A ``mode="dense"`` arm from the same state and batch
    must match the first step's loss and grad norm within 5e-2. A vision
    model's batches carry the pipeline's f32 image embeddings. The phase
    must end within ``mp.limit_s`` where it is set. Returns the path's
    launch counts."""
    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launcher
    from repro_torch.optim import adamw, powersgd, schedule
    from repro_torch.train import train_step

    name = f"{mp.tag}-train"
    t_phase = time.perf_counter()
    cfg = registry.get_config(mp.arch)
    n_micro = cfg.microbatch
    check(cfg.remat and n_micro == mp.n_micro, f"{name} config {cfg}")
    dcfg = pipeline.DataConfig(seed=0, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH,
                               vocab_size=cfg.vocab_size,
                               vision_seq=cfg.vision_seq,
                               vision_dim=cfg.vision_dim)
    opt = adamw.AdamWConfig(
        lr=schedule.linear_warmup_cosine(3e-3, 20, TRAIN_STEPS),
        weight_decay=0.1)
    ps = powersgd.PowerSGDConfig(rank=4)
    batches = [launcher.to_tensors(pipeline.batch_for_step(dcfg, i), dev)
               for i in range(TRAIN_STEPS + 1)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step = train_step.make_train_step(
        cfg, opt, n_micro=n_micro,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))

    def fresh_state():
        state = train_step.init_train_state(0, cfg, opt, device=dev)
        mp.perturb(state["params"], cfg,
                   torch.Generator(device=dev).manual_seed(0))
        state["extra"] = powersgd.init(ps, state["params"])
        return state

    state = fresh_state()
    with tsmm.policy(mode="dense"), recorded() as log:
        m = step(state, batches[0])[1]
    check(log and all(e.executor == "torch-dense" for e in log),
          f"{name} dense arm routes")
    dense = {k: float(m[k]) for k in ("loss", "grad_norm")}
    del state, m, log
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    state = fresh_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 2**30 - before_gb
    n_params = sum(p.numel() for p in state["params"].parameters())
    shapes = {path: st["err"].shape for path, st in state["extra"].items()}
    check(sorted(shapes) == sorted(mp.leaves),
          f"{name} compressed leaves {sorted(shapes)}")
    want, factors, down, s_down, per_step_down = train_prediction(
        mp, cfg, shapes, ps, tokens, dev)
    check(want == mp.train_launches, f"{name} predicted launches {want}, "
          f"not {mp.train_launches}: {factors}")
    want_step = expect(**want)
    zero_counts()
    step_ms, records = [], []
    for i in range(TRAIN_STEPS):
        before = counts()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded() as log:
            state, m = step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grown = {n: v - before[n] for n, v in counts().items()}
        rec = {k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                        "accuracy", "powersgd_compression")
               + tuple(k for k in MOE_METRICS if k in m)}
        rec.update(step=i + 1, step_ok=bool(m["step_ok"]), launches={
            n: v for n, v in grown.items() if v}, ms=step_ms[-1],
            alloc_retries=torch.cuda.memory_stats().get(
                "num_alloc_retries", 0) - retries,
            reserved_gb=torch.cuda.memory_reserved() / 2**30)
        records.append(rec)
        check(rec["step_ok"] and math.isfinite(rec["loss"])
              and math.isfinite(rec["grad_norm"]),
              f"{name} step {i + 1} not ok: {rec}")
        check(grown == want_step, f"{name} launches in step {i + 1}: {grown}")
        rec["p_bodies"] = train_step_routes(
            f"{name} step {i + 1}", log, mp, down, s_down, per_step_down,
            factors)
        del log, m
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # The main path ends here; what follows checks it and measures it.
    loss_err = abs(records[0]["loss"] - dense["loss"]) / abs(dense["loss"])
    gnorm_err = (abs(records[0]["grad_norm"] - dense["grad_norm"])
                 / dense["grad_norm"])
    check(loss_err <= LOGIT_TOL and gnorm_err <= LOGIT_TOL,
          f"{name} kernel vs dense arm: loss {loss_err} grad norm "
          f"{gnorm_err}")
    prof = device_profile(lambda: step(state, batches[TRAIN_STEPS]))
    mid_ms = statistics.median(step_ms)
    emit({"phase": name, "model": cfg.name, "layers": cfg.n_layers,
          "params": n_params, "dtype": cfg.dtype, "n_micro": n_micro,
          "tokens_per_step": tokens, "init_s": init_s, "steps": records,
          "step_ms": step_ms, "median_step_ms": mid_ms,
          "tokens_per_s": tokens / mid_ms * 1e3, "peak_mem_gb": peak_gb,
          "state_mem_gb": state_gb, "mem_before_state_gb": before_gb,
          "dense_arm": dense, "dense_arm_loss_err": loss_err,
          "dense_arm_grad_norm_err": gnorm_err, "factors": factors,
          "remat": cfg.remat,
          "launches_per_step": {n: v for n, v in want_step.items() if v},
          "batch_keys": sorted(batches[0]), "launches": launches,
          "wall_s": time.perf_counter() - t_phase,
          "limit_s": mp.limit_s or None, "gpu": gpu})
    emit({"phase": "profile", "window": f"{name} step", "model": cfg.name,
          **prof, "unprofiled_ms": mid_ms,
          "busy_share": prof["device_busy_ms"] / mid_ms, "gpu": gpu})
    del state, batches
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    check(not mp.limit_s or wall < mp.limit_s,
          f"{name} took {wall} s, over {mp.limit_s}")
    return launches


# ---------------------------------------------------------------------------
# The MoE paths: mixtral-8x7b and deepseek-v3-671b at published width
# ---------------------------------------------------------------------------

MIXTRAL_ARCH = "mixtral-8x7b"
DEEPSEEK_ARCH = "deepseek-v3-671b"
# The cut configs the MoE phases register (registry._MODULES, as the launch
# phase registers LAUNCH_ARCH): published width, the depth one card holds.
# mixtral's first 8 layers serve (11.87 B parameters, 23.7 GB in bf16) and
# its first 2 train (3.16 B; the f32 AdamW moments and accumulator take
# 38 GB); deepseek's first 4 serve (its 3 dense MLA layers and 1 MoE
# layer: 15.11 B, 30.2 GB). One deepseek MoE layer's 11.3 B expert
# parameters need ~140 GB of train state: its train path waits for more
# than one card.
MOE_CUTS = {"mixtral-8x7b-8l": (MIXTRAL_ARCH, 8),
            "mixtral-8x7b-2l": (MIXTRAL_ARCH, 2),
            "deepseek-v3-671b-4l": (DEEPSEEK_ARCH, 4)}
MOE_METRICS = ("moe_balance_loss", "moe_dropped_frac", "moe_max_load")
# tsm2r's shapes on the MoE paths, bf16: mixtral's router at a prefill's
# 8192 and a train microbatch's 4096 tokens (n = 8, the skinny body),
# deepseek's router and MLA's rope key wkr at a prefill's 8192 (k = 7168,
# the wgmma body). mixtral-long's router is [6144,4096]·[4096,8].
MOE_TSM2R = [(8192, 4096, 8), (4096, 4096, 8), (8192, 7168, 256),
             (8192, 7168, 64)]
MOE_ROUTERS = [(8192, 4096, 8), (4096, 4096, 8), (6144, 4096, 8)]
# mixtral-long: one request past the 4,096-token window, so its caches are
# 4,096-slot rings and every decode step wraps.
LONG_PROMPT = 6144
# The capacity factors of the drop-free copies that cached decode is held
# against the teacher-forced forward on (a 4-token decode step drops
# nothing; a 8,192-token prefill at 1.25 drops). mixtral's E / k = 4 gives
# every expert as many slots as tokens. deepseek's largest load at 8,256
# tokens read 4.02 times the mean with no bias (PERF.md), past the 4x
# slots of 4.0: 8.0 gives 2,064 slots an expert, and the phase checks
# that the forward dropped nothing and that no expert was offered more
# tokens than the prefill's slots.
DROP_FREE_CF = {"mixtral": 4.0, "deepseek": 8.0}
# deepseek's router_bias, drawn N(0, 1) * DEEPSEEK_BIAS_SCALE: a tenth of
# the spread of the sigmoid scores (~0.2) it is added to, so it moves some
# tokens' selection without handing a few experts every token.
DEEPSEEK_BIAS_SCALE = 0.02
# The f32 copy that holds cached decode against the forward: mixtral's
# first 2 layers (12.6 GB), deepseek's 3 dense MLA layers (14.6 GB; its
# MoE layer's 11.3 B expert parameters would take 45 GB more in f32).
# The cache's logic alone separates them there: within MOE_F32_TOL.
MOE_F32_LAYERS = {"mixtral": 2, "deepseek": 3}
MOE_F32_TOL = 1e-3
# The share of a cached path's decoded (token, MoE layer) routes whose own
# expert choice may differ from the forward's at the same position. The
# checks pin the forward's choice, so a near-tie that bf16 router logits
# break the other way costs nothing; a decode path that chose wrongly at
# every position would differ nearly everywhere. Read: 7 of mixtral's 480,
# 4 and 5 of deepseek's 60 (256 experts, top 8), 0 of mixtral-long's 120
# (H100 80GB HBM3, 700 W).
MOE_FLIP_SHARE = 0.25


def register_cuts(cuts) -> None:
    """Register ``cuts`` (name -> (arch, layers): ``MOE_CUTS``,
    ``VISION_CUTS``) in the port's registry."""
    from repro_torch.configs import registry

    for name, (arch, layers) in cuts.items():
        cfg = dataclasses.replace(registry.get_config(arch), name=name,
                                  n_layers=layers)
        registry._MODULES[name] = type(
            "M", (), {"CONFIG": cfg, "smoke": staticmethod(lambda c=cfg: c)})


def drop_free(cfg, tag: str):
    """``cfg`` with ``DROP_FREE_CF[tag]`` as its capacity factor: the same
    weights route to the same experts and drop nothing."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DROP_FREE_CF[tag]))


def moe_layers(params, cfg) -> list:
    """The model's MoE layers: deepseek's ``tail``, mixtral's ``layers``."""
    return list(params.tail if cfg.mla is not None else params.layers)


def capacity(cfg, tokens: int) -> int:
    """Slots an expert at ``tokens`` tokens (``moe_fwd``'s, one group)."""
    m = cfg.moe
    return max(8, int(m.capacity_factor * tokens * m.top_k / m.n_experts))


@torch.no_grad()
def cached_steps(params, cfg, prompts, out, dev, pin=None):
    """A prefill of ``prompts`` and cached decode of ``out``'s first NEW - 1
    tokens, with the expert ids ``pin`` gives (``moe_taps``). Returns (the
    logits of every step, each MoE layer call's own routes: the prefill's
    layers, then each step's)."""
    from repro_torch.models import model

    b, s0 = prompts.shape
    cache = model.init_cache(cfg, b, s0 + NEW, device=dev)
    with moe_taps(pin) as (routes, _):
        logits, cache = model.prefill(params, cfg, {"tokens": prompts},
                                      cache)
        steps = [logits]
        for i in range(1, NEW):
            logits, cache = model.decode_step(params, cfg, out[:, i - 1:i],
                                              s0 + i - 1, cache)
            steps.append(logits)
    del cache
    return steps, routes


@torch.no_grad()
def forced_rows(params, cfg, prompts, out):
    """The teacher-forced forward of the prompt and ``out``: its logits at
    the NEW positions the cached steps predict, and each MoE layer's
    routes and metrics."""
    from repro_torch.models import model

    s0 = prompts.shape[1]
    with moe_taps() as (routes, mets):
        forced, _ = model.forward(
            params, cfg, {"tokens": torch.cat([prompts, out], dim=1)})
    rows = forced[:, s0 - 1:s0 - 1 + NEW].clone()
    del forced
    torch.cuda.empty_cache()
    return rows, routes, mets


def forward_pin(forward_routes, b: int, s0: int):
    """The ``moe_taps`` pin that gives each MoE layer call of a cached path
    (its prefill's calls, one a layer, then one a layer a decode step) the
    forward's expert ids at the same positions."""
    n = len(forward_routes)
    ids = [r.reshape(b, s0 + NEW, -1) for r in forward_routes]

    def pin(call: int):
        step, layer = divmod(call, n)
        lo, hi = (0, s0) if step == 0 else (s0 + step - 1, s0 + step)
        return ids[layer][:, lo:hi].reshape(-1, ids[layer].shape[-1])
    return pin


def by_position(routes, n: int, b: int, s0: int, cached: bool):
    """Each MoE layer's expert sets at positions 0 .. S0 + NEW - 2, (L, B,
    P, k): a cached path's (``cached``: its prefill's L calls, then L a
    decode step) or a forward's (L calls over all S0 + NEW positions)."""
    if cached:
        return experts(torch.stack([torch.cat(
            [routes[layer].reshape(b, s0, -1)]
            + [routes[n * i + layer].reshape(b, 1, -1)
               for i in range(1, NEW)], dim=1) for layer in range(n)]))
    return experts(torch.stack([r.reshape(b, s0 + NEW, -1)[:, :s0 + NEW - 1]
                                for r in routes]))


def step_err(steps, ref) -> float:
    """The largest normalised error of a step's logits against ``ref``'s
    at its step, each request normalised by its own reference."""
    return max(float(((s.float() - r.float()).abs().amax(-1)
                      / r.float().abs().amax(-1)).max())
               for s, r in zip(steps, ref))


def pinned_check(name, steps, routes, rows, forward_routes, b, s0,
                 tol) -> dict:
    """Cached ``steps``, taken with the forward's expert ids pinned
    (``forward_pin``), against the forward's ``rows``: every step of every
    request within ``tol``. The cached path's own choices (``routes``)
    that differ from the forward's are counted, at the prompt's and at
    the decoded positions; at most ``MOE_FLIP_SHARE`` of the decoded
    routes may."""
    rec = {"err": step_err(steps, [rows[:, i] for i in range(NEW)]),
           "tol": tol}
    n = len(forward_routes)
    if n:
        flip = (by_position(routes, n, b, s0, True)
                != by_position(forward_routes, n, b, s0, False)).any(-1)
        rec.update(prompt_flips=int(flip[:, :, :s0].sum()),
                   prompt_routes=flip[:, :, :s0].numel(),
                   decode_flips=int(flip[:, :, s0:].sum()),
                   decode_routes=flip[:, :, s0:].numel())
    check(rec["err"] <= tol and rec.get("decode_flips", 0)
          <= MOE_FLIP_SHARE * rec.get("decode_routes", 0),
          f"{name}: {rec}")
    return rec


@torch.no_grad()
def f32_cut(params, cfg, layers: int, dev):
    """The model's first ``layers`` layers, its embedding, final norm and
    head, copied in f32 (for deepseek's 3: its dense MLA layers)."""
    from repro_torch.models import model

    cut_cfg = dataclasses.replace(cfg, dtype="float32", n_layers=layers)
    p32 = model.LM(cut_cfg, device=dev)
    src = params.state_dict()
    p32.load_state_dict({k: src[k] for k in p32.state_dict()})
    return p32, cut_cfg


def moe_decode_check(mp, params, cfg, prompts, out, step_logits, gen,
                     dev, extras=None) -> dict:
    """Cached decode against the teacher-forced forward, both on the
    drop-free copy of ``cfg`` (``drop_free``). The forward must drop
    nothing, and no expert of it may have been offered more tokens than
    the drop-free prefill's slots (so the prefill, on a subset of the
    same tokens, dropped nothing either).

    The router's logits are products in the activations' dtype (the
    reference's cast, ``moe.route``): in bf16 a step whose hidden state
    differs from the forward's in its last bits picks another expert
    where two lie within a rounding, and from there computes another
    function. So the cached path takes the forward's expert ids
    (``pinned_check``): every step of every request within ``LOGIT_TOL``,
    its own differing choices counted. The cache's logic is held again on
    an f32 copy of the first ``MOE_F32_LAYERS`` layers at full width,
    within ``MOE_F32_TOL``. Under MLA the non-absorbed decode
    (``mla_absorb=False``) is held likewise, and against the absorbed
    one within ``LOGIT_TOL``. (``step_logits``, ``gen`` and ``extras``,
    which ``ModelPath.decode_check`` passes, go unused.)"""
    free = drop_free(cfg, mp.tag)
    b, s0 = prompts.shape
    rows, forced_routes, mets = forced_rows(params, free, prompts, out)
    tokens = out.numel() + prompts.numel()
    m = free.moe
    offered = max(met["moe_max_load"] * tokens * m.top_k / m.n_experts
                  for met in mets)
    rec = {"drop_free_cf": m.capacity_factor,
           "forced_dropped_frac": [met["moe_dropped_frac"] for met in mets],
           "forced_most_offered": offered,
           "prefill_slots": capacity(free, prompts.numel())}
    check(all(met["moe_dropped_frac"] == 0 for met in mets)
          and offered <= rec["prefill_slots"],
          f"{mp.tag} drop-free copy dropped: {rec}")
    pin = forward_pin(forced_routes, b, s0)
    arms = [("", free)]
    if cfg.mla is not None:
        arms.append(("plain_", dataclasses.replace(free, mla_absorb=False)))
    taken = {}
    for arm, arm_cfg in arms:
        taken[arm], routes = cached_steps(params, arm_cfg, prompts, out, dev,
                                          pin)
        rec[f"{arm}vs_forward"] = pinned_check(
            f"{mp.tag} {arm}decode vs forward", taken[arm], routes, rows,
            forced_routes, b, s0, LOGIT_TOL)
    if cfg.mla is not None:
        rec["absorbed_vs_plain_err"] = step_err(taken[""], taken["plain_"])
        check(rec["absorbed_vs_plain_err"] <= LOGIT_TOL,
              f"{mp.tag} absorbed vs plain MLA decode: {rec}")
    del taken, rows
    torch.cuda.empty_cache()
    p32, cfg32 = f32_cut(params, free, MOE_F32_LAYERS[mp.tag], dev)
    rows32, forced32, _ = forced_rows(p32, cfg32, prompts, out)
    pin32 = forward_pin(forced32, b, s0)
    rec["f32_layers"] = cfg32.n_layers
    for arm, arm_cfg in arms:
        steps32, routes32 = cached_steps(
            p32, dataclasses.replace(arm_cfg, dtype="float32",
                                     n_layers=cfg32.n_layers),
            prompts, out, dev, pin32)
        rec[f"f32_{arm}vs_forward"] = pinned_check(
            f"{mp.tag} f32 {arm}decode vs forward", steps32, routes32, rows32,
            forced32, b, s0, MOE_F32_TOL)
    del p32, steps32, rows32
    torch.cuda.empty_cache()
    emit({"phase": f"{mp.tag}-decode", "prompt": s0, **rec})
    return rec


@torch.no_grad()
def deepseek_perturb_(params, cfg, gen) -> None:
    """Draw every MoE layer's ``router_bias`` from ``gen``
    (``DEEPSEEK_BIAS_SCALE``), in place."""
    for lp in moe_layers(params, cfg):
        b = lp.ffn.router_bias
        b.copy_(torch.randn(b.shape, generator=gen, device=b.device)
                * DEEPSEEK_BIAS_SCALE)


@torch.no_grad()
def swap_router_columns(params, cfg):
    """Swap the router columns of experts 0 and 1 in every MoE layer;
    returns the undo."""
    ws = [lp.ffn.router_w for lp in moe_layers(params, cfg)]

    def swap():
        with torch.no_grad():
            for w in ws:
                w[:, [0, 1]] = w[:, [1, 0]]
    swap()
    return swap


def mixtral_prefill_shapes(cfg, rows: int) -> list:
    """tsm2r's shapes in a mixtral prefill: the router of every layer."""
    return [(rows, cfg.d_model, cfg.moe.n_experts)] * cfg.n_layers


def deepseek_prefill_shapes(cfg, rows: int) -> list:
    """tsm2r's shapes in a deepseek prefill: MLA's wkr in every layer and
    the router of every MoE layer."""
    return sorted([(rows, cfg.d_model, cfg.mla.rope_dim)] * cfg.n_layers
                  + [(rows, cfg.d_model, cfg.moe.n_experts)]
                  * (cfg.n_layers - cfg.first_k_dense))


# A mixtral-train step's launches, predicted from the classifier and the
# chooser (model_train_phase checks the prediction on the card): the
# router twice a layer and microbatch (forward and remat recompute, 2 x 2
# x 4) on tsm2r_split (the chooser's S = 8 at [4096,4096]·[4096,8]); P of
# embed and lm_head on tsm2r at S = 1, Q of both on the one-launch tsmt.
MIXTRAL_TRAIN_LAUNCHES = {"tsm2r_split": 16, "tsm2r": 2, "tsmt": 2}
MIXTRAL_PATH = ModelPath(
    tag="mixtral", arch="mixtral-8x7b-8l",
    perturb=lambda params, cfg, gen: None,
    prefill_shapes=mixtral_prefill_shapes,
    # wq, wk, wv, wo and the router of every layer (the experts' grouped
    # products are bmm, outside tsmm)
    decode_gemms=lambda cfg: 5 * cfg.n_layers,
    reach=swap_router_columns,
    reach_what="router columns of experts 0 and 1 swapped",
    decode_check=moe_decode_check, body="skinny", n_micro=4,
    micro_downs=lambda cfg: 2 * cfg.n_layers,
    leaves=("embed.table", "lm_head.table"),
    train_launches=MIXTRAL_TRAIN_LAUNCHES)
MIXTRAL_TRAIN_PATH = MIXTRAL_PATH._replace(arch="mixtral-8x7b-2l")
DEEPSEEK_PATH = ModelPath(
    tag="deepseek", arch="deepseek-v3-671b-4l", perturb=deepseek_perturb_,
    prefill_shapes=deepseek_prefill_shapes,
    # MLA's wdq, wuq, wdkv, wkr, wo every layer (the absorbed decode folds
    # wukv into f32 einsums); the dense layers' FFN; the MoE layers'
    # router and shared expert
    decode_gemms=lambda cfg: (5 * cfg.n_layers + 3 * cfg.first_k_dense
                              + 4 * (cfg.n_layers - cfg.first_k_dense)),
    reach=zeroed(lambda p, cfg: [lp.ffn.router_bias
                                 for lp in moe_layers(p, cfg)]),
    reach_what="router_bias zeroed", decode_check=moe_decode_check)


def mixtral_long_phase(params, cfg, dev, gpu, counts, zero_counts,
                       expect) -> dict:
    """mixtral-long: the served mixtral (``params``) on one request of
    ``LONG_PROMPT`` tokens, past its 4,096-token window, and 16 greedy
    tokens: every layer's K/V cache a 4,096-slot ring written in place.
    The path (counts zeroed before, read after) is a greedy request and
    the same request step by step for times; each prefill launches the
    router at [6144,4096]·[4096,8] on the skinny body, at the chooser's S.
    Then ring decode against the windowed teacher-forced forward, both on
    the drop-free copy, within ``LOGIT_TOL`` (``moe_decode_check``).
    Returns the path's counts."""
    from repro_torch.models import model
    from repro_torch.serve import engine

    name = "mixtral-long"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                            generator=gen, device=dev)
    shapes = mixtral_prefill_shapes(cfg, LONG_PROMPT)
    per_prefill, splits = router_launches(shapes, torch.bfloat16, dev)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with recorded() as log:
        t0 = time.perf_counter()
        out = engine.generate(params, cfg, prompts, NEW, device=dev)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    bodies = prefill_route_check(name, log, shapes, splits, "skinny",
                                 LONG_PROMPT)
    decode_events = [e for e in log if e.shape[0] == 1]
    check(len(decode_events) == (NEW - 1) * MIXTRAL_PATH.decode_gemms(cfg)
          and all(e.executor == "torch-dense" for e in decode_events),
          f"every {name} decode projection goes to torch-dense")
    step_logits, prefill_ms, decode_ms = serve_step_by_step(
        params, cfg, prompts, out, dev, sum(per_prefill.values()), counts)
    launches = counts()
    check(launches == expect(**{k: 2 * v for k, v in per_prefill.items()}),
          f"{name} path launches {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    cache = model.init_cache(cfg, 1, LONG_PROMPT + NEW, device=dev)
    ring = [tuple(c["k"].shape) for c in cache]
    check(all(s == (1, cfg.attn_window, cfg.n_kv_heads,
                    cfg.resolved_head_dim) for s in ring),
          f"{name} caches {ring[:1]}")
    del cache
    decode = moe_decode_check(MIXTRAL_PATH, params, cfg, prompts, out,
                              step_logits, gen, dev)
    emit({"phase": name, "model": cfg.name, "layers": cfg.n_layers,
          "batch": 1, "prompt": LONG_PROMPT, "new": NEW,
          "window": cfg.attn_window, "cache_slots": cfg.attn_window,
          "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": LONG_PROMPT / prefill_ms * 1e3,
          "decode_ms_per_step": decode_ms, "greedy_request_s": greedy_s,
          "launches_per_prefill": per_prefill,
          "splits": {str(list(k)): v for k, v in splits.items()},
          "tsm2r_body": bodies, **decode, "peak_mem_gb": peak_gb,
          "launches": launches, "wall_s": time.perf_counter() - t_phase,
          "gpu": gpu})
    del prompts, out, step_logits
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# hubert-xlarge (the audio family) served and trained at its published
# width and depth
# ---------------------------------------------------------------------------

HUBERT_ARCH = "hubert-xlarge"
# The offline ABFT tree check's product at a w_down leaf, [5120,1280]^T .
# [5120,2] f32: the one-launch tsmt at S = 1 (the tree check's kernel).
HUBERT_CHECK = (5120, 1280, 2)
# PowerSGD's leaves, in the JAX layout: every factor of them routes dense.
HUBERT_LEAVES = ("embed.table", "frame_proj.w", "lm_head.table",
                 "segments.0.ffn.b_up")
# The bf16 encode's logits against an f32 copy of the same weights
# (normalised error), and the least normalised change of the first
# frame's logits when the last frame is drawn again.
HUBERT_F32_TOL = LOGIT_TOL
HUBERT_REACH = 1e-3
# hubert-train's launcher arguments: global batch 8 x 2048 frames in the
# config's 4 microbatches, PowerSGD rank 4, a save after the offline ABFT
# check at each step. Two steps, not three: the script's command time
# passed 950 s with three (PERF.md section 6).
HUBERT_STEPS = 2
HUBERT_TRAIN_ARGV = ["--arch", HUBERT_ARCH, "--global-batch",
                     str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                     "--powersgd-rank", "4", "--steps", str(HUBERT_STEPS),
                     "--ckpt-every", "1", "--abft-every", "1",
                     "--log-every", "1"]
# About 1.5x each phase's first run as it stands on an NVIDIA H100 80GB
# HBM3 at 700 W: 13.1 s, 78.3 s and 20.5 s (PERF.md section 6, run 4);
# the serve's about 2x its runs of 13.1 and 11.2 s, the headroom the
# vision limits have, since a slow host ran it at 21.6 s with every other
# check held.
HUBERT_SERVE_MAX_S = 26.0
HUBERT_TRAIN_MAX_S = 120.0
MESH_HUBERT_MAX_S = 31.0


@torch.no_grad()
def hubert_perturb_(params, cfg, gen) -> None:
    """Give the hubert leaves that start constant values drawn from
    ``gen``, in place: every GELU MLP's ``b_up`` and ``b_down`` and every
    LayerNorm's scale and bias (the final norm's too)."""
    del cfg
    norms = [n for lp in params.layers for n in (lp.norm1, lp.norm2)]
    for norm in [*norms, params.final_norm]:
        for t, base in ((norm.scale, 1.0), (norm.bias, 0.0)):
            t.copy_(base + 0.1 * torch.randn(t.shape, generator=gen,
                                             device=t.device))
    for lp in params.layers:
        for t in (lp.ffn.b_up, lp.ffn.b_down):
            t.copy_(0.1 * torch.randn(t.shape, generator=gen,
                                      device=t.device))


def hubert_frames(cfg, gen, dev):
    """BATCH x PROMPT seeded bf16 frames (about 41 s of audio each at
    HuBERT's 50 frames a second)."""
    return torch.randn((BATCH, PROMPT, cfg.frame_dim), generator=gen,
                       device=dev).to(torch.bfloat16)


def hubert_projections(cfg) -> list:
    """The (m, k, n) of every projection of a BATCH x PROMPT forward:
    frame_proj, then wq, wk, wv, wo, w_up and w_down of each layer."""
    rows, d = BATCH * PROMPT, cfg.d_model
    qkv = cfg.n_heads * cfg.resolved_head_dim
    return [(rows, cfg.frame_dim, d)] + cfg.n_layers * [
        (rows, d, qkv), (rows, d, qkv), (rows, d, qkv), (rows, qkv, d),
        (rows, d, cfg.d_ff), (rows, cfg.d_ff, d)]


def hubert_serve_phase(mp, dev, gpu, counts, zero_counts, expect) -> dict:
    """hubert-serve: hubert-xlarge at published width and depth, bf16,
    the weights ``serve_weights`` builds (seed 0, ``hubert_perturb_``),
    BATCH x PROMPT seeded bf16 frames. The path, from zeroed counts:
    ``model.forward`` (the encode step: every frame's logits) timed as a
    median of 3 after a warm-up, and a prefill that fills the K/V caches
    and returns the last frame's logits. Checks: every one of the
    forward's 289 projections routes dense (no kernel launches on the
    path); the prefill's logits are the forward's last frame's; drawing
    the last frame again changes the first frame's logits (a causal mask
    would leave them bit for bit); the bf16 logits within
    ``HUBERT_F32_TOL`` of an f32 copy of the same weights. Then a
    profiled forward. Keeps the frames and logits in ``SERVE_REF`` for
    mesh-hubert. Returns the path's launch counts."""
    from repro_torch.models import model

    name = f"{mp.tag}-serve"
    t_phase = time.perf_counter()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg, gen = serve_weights(mp, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    frames = hubert_frames(cfg, gen, dev)
    batch = {"frames": frames}

    def encode(b=batch):
        with torch.no_grad():
            return model.forward(params, cfg, b)[0]

    with recorded() as log:
        logits = encode()
        forward_ms = time_ms(encode)
        cache = model.init_cache(cfg, BATCH, PROMPT, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = model.prefill(params, cfg, batch, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    # The main path ends here; what follows only checks it.
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    shapes = hubert_projections(cfg)
    first = log[:len(shapes)]
    check(len(shapes) == 1 + 6 * cfg.n_layers
          and [e.shape for e in first] == shapes
          and all(e.kind == "dense" and e.executor == "torch-dense"
                  for e in log),
          f"{name}: {len(first)} projections a forward, routes "
          f"{sorted({(e.kind, e.executor) for e in log})}")
    check(launches == expect(), f"{name} path launches {launches}")
    check(logits.shape == (BATCH, PROMPT, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{name} logits {tuple(logits.shape)}")
    prefill_err = normalised_err(last, logits[:, -1])
    prefill_bits = same_bits(last, logits[:, -1].contiguous())
    check(prefill_err <= 1e-5, f"{name}: prefill's logits {prefill_err} "
          f"from the forward's last frame")
    check(len(cache) == cfg.n_layers and all(
        bool(torch.isfinite(e["k"]).all()) and bool(e["k"].abs().sum() > 0)
        for e in cache), f"{name} caches")
    del cache
    moved = frames.clone()
    moved[:, -1] = hubert_frames(cfg, gen, dev)[:, -1]
    reach_err = normalised_err(encode({"frames": moved})[:, 0],
                               logits[:, 0])
    check(reach_err > HUBERT_REACH, f"{name}: drawing the last frame again "
          f"moves the first frame's logits by {reach_err}: the encoder is "
          "not bidirectional")
    p32, cfg32 = f32_copy(params, cfg, dev)
    with torch.no_grad():
        logits32, _ = model.forward(p32, cfg32, {"frames": frames.float()})
    f32_err = normalised_err(logits, logits32)
    del p32, logits32
    torch.cuda.empty_cache()
    check(f32_err <= HUBERT_F32_TOL, f"{name}: bf16 logits {f32_err} from "
          f"the f32 copy's (tolerance {HUBERT_F32_TOL})")
    prof = device_profile(encode)
    SERVE_REF[mp.tag] = {"frames": frames.cpu(), "logits": logits.cpu(),
                         "last": last.cpu(), "forward_ms": forward_ms,
                         "prefill_ms": prefill_ms}
    wall = time.perf_counter() - t_phase
    emit({"phase": name, "model": cfg.name, "params": n_params,
          "dtype": cfg.dtype, "layers": cfg.n_layers, "batch": BATCH,
          "frames": PROMPT, "init_s": init_s, "forward_ms": forward_ms,
          "frames_per_s": BATCH * PROMPT / forward_ms * 1e3,
          "prefill_ms": prefill_ms, "projections_per_forward": len(shapes),
          "routes": sorted({(e.kind, e.executor) for e in log}),
          "prefill_vs_forward_err": prefill_err,
          "prefill_bit_equal": prefill_bits,
          "last_frame_moves_first_err": reach_err,
          "f32_copy_err": f32_err, "f32_tol": HUBERT_F32_TOL,
          "peak_mem_gb": peak_gb, "launches": launches, "wall_s": wall,
          "limit_s": HUBERT_SERVE_MAX_S, "gpu": gpu})
    emit({"phase": "profile", "window": f"{name} forward", "model": cfg.name,
          **prof, "unprofiled_ms": forward_ms,
          "busy_share": prof["device_busy_ms"] / forward_ms, "gpu": gpu})
    check(wall < HUBERT_SERVE_MAX_S, f"{name} took {wall} s, over "
          f"{HUBERT_SERVE_MAX_S}")
    del params, logits, last, frames, moved
    torch.cuda.empty_cache()
    return launches


def hubert_train_phase(dev, gpu, counts, zero_counts, expect) -> dict:
    """hubert-train: ``repro_torch.launch.train.main`` as the launch phase
    calls it (on the card, counts zeroed before and read after, its calls
    timed by ``launch_timers``) with ``HUBERT_TRAIN_ARGV`` at full width
    and depth: the pipeline's f32 frames over bf16 weights, as the
    reference's train step runs, PowerSGD on ``HUBERT_LEAVES``, remat, a
    checkpoint (to a temporary directory, removed after) after each of
    the ``HUBERT_STEPS`` steps, each after the offline ABFT tree check
    (``encode_tree``, then ``verify_tree``'s second encode). Checks:
    every step's loss finite, no fault events or retries; every PowerSGD
    factor routes dense; the run's launches are the tree checks' alone,
    two encodes a save of what
    ``tree_check_prediction`` predicts (tsmt at every ``ffn.w_down``
    leaf, ``HUBERT_CHECK``, at the chooser's S), each routed event at
    its shape and S. Returns the path's launch counts."""
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.launch import train as launcher
    from repro_torch.models import model

    name = "hubert-train"
    t_phase = time.perf_counter()
    cfg = registry.get_config(HUBERT_ARCH)
    want, splits, shapes = tree_check_prediction(
        model.LM(cfg, device="meta"), dev)
    check(want == {"tsmt": cfg.n_layers}
          and set(shapes) == {HUBERT_CHECK} and splits[HUBERT_CHECK] == 1,
          f"{name}: the tree check's prediction {want} {splits}")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_hubert_")
    argv = HUBERT_TRAIN_ARGV + ["--ckpt-dir", ckpt_dir]
    out = io.StringIO()
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with launch_timers() as timed, recorded() as log, \
                contextlib.redirect_stdout(out):
            res = launcher.main(argv)
        wall = time.perf_counter() - t0
        launches = counts()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    # The path ends here; what follows only checks it.
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    printed = out.getvalue()
    losses = [float(v) for v in re.findall(r"\[train\] step \d+ loss (\S+)",
                                           printed)]
    steps = [r["s"] * 1e3 for r in timed if r["what"] == "step"]
    encodes = 2 * HUBERT_STEPS
    check(len(losses) == len(steps) == HUBERT_STEPS
          and all(map(math.isfinite, losses))
          and math.isfinite(res["final_loss"]) and res["fault_events"] == 0
          and res["fault_retries"] == 0,
          f"{name}: losses {losses}, result {res}:\n{printed}")
    factors = [e for e in log if e.shape[2] == 4]
    check(len(factors) == 2 * len(HUBERT_LEAVES) * len(steps) and all(
        e.kind == "dense" for e in factors) and {e.shape for e in factors}
        == {(512, 1280, 4), (504, 1280, 4), (48, 5120, 4)},
        f"{name} PowerSGD factor routes "
        f"{sorted({(e.entry, e.kind, e.shape) for e in factors})}")
    routed = [e for e in log if e.kind != "dense"]
    check(launches == expect(**{k: encodes * v for k, v in want.items()}),
          f"{name} launches {launches}, predicted {want} an encode")
    check(len(routed) == encodes * len(shapes) and all(
        e.kind == "tsmt" and e.executor == "cuda" and e.shape == HUBERT_CHECK
        and all(lm.splits == splits[e.shape] for lm in e.launches)
        for e in routed), f"{name} tree check routes {routed[:2]}")
    checks = [r for r in timed if r["what"].startswith("abft")]
    check(len(checks) == encodes and all(
        r["launches"]["tsmt"] == len(shapes) for r in checks),
        f"{name} offline checks {checks}")

    def calls(*whats):
        return [{k: v for k, v in c.items() if k != "launches"}
                for c in timed if c["what"] in whats]

    state_gb = [r["gb"] for r in timed if r["what"] == "snapshot"]
    emit({"phase": name, "model": cfg.name, "layers": cfg.n_layers,
          "argv": HUBERT_TRAIN_ARGV, "result": res, "losses": losses,
          "step_ms": steps, "median_step_ms_after_first":
              statistics.median(steps[1:]),
          "frames_per_s_after_first": TRAIN_BATCH * TRAIN_SEQ
          / statistics.median(steps[1:]) * 1e3,
          "state_gb": state_gb[0] if state_gb else None,
          "snapshot": calls("snapshot"),
          "save": calls("save enqueue", "checkpoint write", "save durable"),
          "offline_check": [{"what": c["what"], "ms": c["s"] * 1e3,
                             "launches": c["launches"]} for c in checks],
          "tree_check_per_encode": want,
          "tree_check_splits": {str(list(k)): v for k, v in splits.items()},
          "powersgd_factors": sorted({(e.entry, e.kind, e.shape)
                                      for e in factors}),
          "peak_mem_gb": peak_gb, "launches": {n: v for n, v in
                                               launches.items() if v},
          "wall_s": wall, "limit_s": HUBERT_TRAIN_MAX_S, "gpu": gpu})
    check(wall < HUBERT_TRAIN_MAX_S, f"{name} took {wall} s, over "
          f"{HUBERT_TRAIN_MAX_S}")
    torch.cuda.empty_cache()
    return launches


HUBERT_PATH = ModelPath(
    tag="hubert", arch=HUBERT_ARCH, perturb=hubert_perturb_,
    # no projection of the encode routes to a kernel, nor of a train step
    prefill_shapes=lambda cfg, rows: [], decode_gemms=lambda cfg: 0,
    reach=None, reach_what="", decode_check=None, n_micro=4,
    micro_downs=lambda cfg: 0, leaves=HUBERT_LEAVES, train_launches={},
    encoder=True)


def mesh_encode_check(name, cfg, params, ref, mesh, dev, counts,
                      zero_counts, expect) -> tuple:
    """An encoder's serve on DTensor parameters (the decode-free arm of
    ``mesh_model_path``), held against its plain serve run ``ref``
    (``hubert_serve_phase``'s ``SERVE_REF`` entry). ``params`` are placed
    in place by ``sharding.make_param_specs`` on ``mesh``; then, from
    zeroed counts, ``model.forward`` of the plain run's frames (placed by
    ``batch_specs``) and a ``make_serve_fns(sharded_projections=True)``
    prefill into caches from ``init_cache(mesh=)``, each timed on the
    host clock. Checks: the forward's logits and the prefill's bit-equal
    to the plain run's, every projection dense (no launch), every cache
    entry where ``cache_specs`` puts it, the parameters still in their
    placements. Returns (the launches, the specs, the line's fields)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    from repro_torch.serve import engine

    specs = sharding.make_param_specs(cfg, params, mesh)
    sharding.named(mesh, specs, params)
    frames = ref["frames"].to(dev)
    torch.cuda.synchronize()
    zero_counts()
    with recorded() as log:
        batch = sharding.named(mesh, sharding.batch_specs(
            cfg, mesh, {"frames": frames}), {"frames": frames})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = model.forward(params, cfg, batch)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        prefill_step, _ = engine.make_serve_fns(cfg,
                                                sharded_projections=True)
        cache = model.init_cache(cfg, BATCH, PROMPT, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = prefill_step(params, batch, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    misplaced = cache_misplaced(cfg, mesh, cache)
    del cache
    check(launches == expect() and log and all(
        e.kind == "dense" for e in log), f"{name} serve launches "
        f"{launches}, routes {sorted({(e.kind, e.executor) for e in log})}")
    check(same_bits(logits.full_tensor(), ref["logits"].to(dev)),
          f"{name} forward logits differ from the plain serve phase's")
    check(same_bits(last.full_tensor(), ref["last"].to(dev)),
          f"{name} prefill logits differ from the plain serve phase's")
    check(not misplaced, f"{name} caches out of their specs' placements: "
          f"{misplaced}")
    check(not placed_as(mesh, dict(params.named_parameters()), specs),
          f"{name} parameters left their placements")
    return launches, specs, {
        "forward_ms": forward_ms, "plain_forward_ms": ref["forward_ms"],
        "prefill_ms": prefill_ms, "plain_prefill_ms": ref["prefill_ms"],
        "projections": len(log) // 2, "caches_in_spec": True,
        "bit_equal": {"forward_logits": True, "prefill_logits": True}}



# ---------------------------------------------------------------------------
# The vision paths: llama-3.2-vision-11b at published width
# ---------------------------------------------------------------------------

VISION_ARCH = "llama-3.2-vision-11b"
# The train and mesh cut: one whole group (4 self-attention layers and
# the gated cross-attention layer; ``segments`` floors n_layers by the
# period, so a 4-layer cut would hold none), registered as LAUNCH_ARCH is.
VISION_CUT = "llama-3.2-vision-11b-5l"
VISION_CUTS = {VISION_CUT: (VISION_ARCH, 5)}
# A train step's launches, which train_prediction must predict: P and Q
# of the two leaves, nothing else (every projection's n is 1,024 or more,
# past MAX_SKINNY).
VISION_TRAIN_LAUNCHES = {"tsm2r": 2, "tsmt": 2}
# The f32 copy of the first group: its cached decode against its
# teacher-forced forward (the caches' logic without bf16 rounding).
VISION_F32_TOL = 1e-3
# Each vision phase's limit in seconds: about 1.5x its first run on an
# NVIDIA H100 80GB HBM3 at 700 W, 1.8-2.0x its run in the whole script
# there (17.1 s, 19.9 s and 22.8 s), room for a slow host (PERF.md
# section 6).
VISION_SERVE_MAX_S = 32.0
VISION_TRAIN_MAX_S = 40.0
MESH_VISION_MAX_S = 40.0


def vision_gates(params, cfg=None) -> list:
    """Both gates of every cross layer: 0-d f32 parameters."""
    del cfg
    return [t for g in params.groups
            for t in (g.cross.gate_attn, g.cross.gate_ffn)]


@torch.no_grad()
def vision_perturb_(params, cfg, gen) -> None:
    """Draw both gates of every cross layer from ``gen`` (N(0, 1)), in
    place: at their initial zero, tanh(0) multiplies the image path
    away."""
    for t in vision_gates(params, cfg):
        t.copy_(torch.randn((), generator=gen, device=t.device))


def vision_images(cfg, gen, dev) -> dict:
    """Each request's own seeded f32 image embeddings, (BATCH,
    vision_seq, vision_dim): the dtype the reference's pipeline and serve
    example give."""
    return {"image_embeds": torch.randn(
        (BATCH, cfg.vision_seq, cfg.vision_dim), generator=gen, device=dev)}


def vision_decode_gemms(cfg) -> int:
    """The projections of one decode step, every one dense at 4 rows: wq,
    wk, wv, wo and the MLP's three of each self-attention layer; wq, wo
    and the MLP's three of each cross layer (its K/V are the cache)."""
    period = cfg.cross_attn_period
    return cfg.n_layers // period * (7 * (period - 1) + 5)


@torch.no_grad()
def vision_cache_check(params, cfg, prompts, out, dev, extras) -> dict:
    """A prefill and NEW - 1 cached decode steps of ``out``: the cross
    caches hold the image embeddings' dtype (f32: prefill replaces the
    entry, no rounding into the bf16 zeros), at ``vision_seq`` positions,
    and the decode steps leave them bit for bit; the self-attention
    caches stay in the model's dtype."""
    from repro_torch.models import model

    cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    _, cache = model.prefill(params, cfg, {"tokens": prompts, **extras},
                             cache)
    period = cfg.cross_attn_period     # each group's last entry
    cross = [i for i in range(len(cache)) if i % period == period - 1]
    kept = {i: {k: t.clone() for k, t in cache[i].items()} for i in cross}
    for i in range(1, NEW):
        _, cache = model.decode_step(params, cfg, out[:, i - 1:i],
                                     PROMPT + i - 1, cache)
    rec = {"cross_caches": len(cross),
           "cross_cache_dtypes": sorted({str(t.dtype)[6:] for i in cross
                                         for t in cache[i].values()}),
           "self_cache_dtypes": sorted({
               str(t.dtype)[6:] for i, e in enumerate(cache)
               if i not in cross for t in e.values()}),
           "cross_cache_shape": list(cache[cross[0]]["k"].shape),
           "cross_cache_untouched_by_decode": all(
               torch.equal(cache[i][k], kept[i][k]) for i in cross
               for k in kept[i])}
    want = str(extras["image_embeds"].dtype)[6:]
    check(len(cross) == cfg.n_layers // cfg.cross_attn_period
          and rec["cross_cache_dtypes"] == [want]
          and rec["self_cache_dtypes"] == [cfg.dtype]
          and rec["cross_cache_shape"] == [BATCH, cfg.vision_seq,
                                           cfg.n_kv_heads,
                                           cfg.resolved_head_dim]
          and rec["cross_cache_untouched_by_decode"],
          f"vision cross caches: {rec}")
    return rec


@torch.no_grad()
def vision_reach_check(params, cfg, prompts, served, dev, extras) -> dict:
    """The image reaches the logits, both ways: with the gates drawn, each
    request given the next request's image moves the last logits past
    LOGIT_TOL from ``served`` (the served prefill's); with both gates of
    every cross layer at zero, the swap leaves them bit for bit."""
    from repro_torch.models import model

    rolled = {k: v.roll(1, dims=0) for k, v in extras.items()}

    def last(ex):
        return model.prefill(params, cfg, {"tokens": prompts, **ex},
                             model.init_cache(cfg, BATCH, PROMPT,
                                              device=dev))[0]

    swap_err = normalised_err(last(rolled), served)
    undo = zeroed(vision_gates)(params, cfg)
    try:
        zero_equal = same_bits(last(extras), last(rolled))
    finally:
        undo()
    check(swap_err > LOGIT_TOL and zero_equal,
          f"vision image reach: another request's image moves the logits "
          f"by {swap_err} (past {LOGIT_TOL}?); at zero gates bit-equal: "
          f"{zero_equal}")
    return {"swapped_image_err": swap_err,
            "zero_gates_swap_bit_equal": zero_equal}


def vision_f32_check(params, cfg, prompts, out, dev, extras) -> dict:
    """The first group (``cross_attn_period`` layers, the cross layer
    last), the embedding, final norm and head copied in f32
    (``f32_cut``): its cached decode within ``VISION_F32_TOL`` of its
    teacher-forced forward, and the bf16 model cut to the same group (the
    served tensors, no copy) within ``LOGIT_TOL`` of it at the prefill."""
    from repro_torch.models import model

    period = cfg.cross_attn_period
    p32, cfg32 = f32_cut(params, cfg, period, dev)
    steps32, rows32 = decode_and_forward(p32, cfg32, prompts, out,
                                         prompts[:, :0], dev, extras)
    f32_err = max_step_err(steps32, rows32)
    del p32, rows32
    torch.cuda.empty_cache()
    cut_cfg = dataclasses.replace(cfg, n_layers=period)
    cut = model.LM(cut_cfg, device="meta")
    cut.load_state_dict({k: v for k, v in params.state_dict().items()
                         if not k.startswith("groups.")
                         or k.startswith("groups.0.")}, assign=True)
    with torch.no_grad():
        cut_logits, _ = model.prefill(
            cut, cut_cfg, {"tokens": prompts, **extras},
            model.init_cache(cut_cfg, BATCH, PROMPT, device=dev))
    bf16_err = normalised_err(cut_logits, steps32[0])
    del cut, steps32
    check(f32_err <= VISION_F32_TOL and bf16_err <= LOGIT_TOL,
          f"vision f32 cut: decode vs forward {f32_err} (tolerance "
          f"{VISION_F32_TOL}), bf16 cut vs f32 {bf16_err} (tolerance "
          f"{LOGIT_TOL})")
    return {"f32_layers": period, "f32_decode_vs_forward_err": f32_err,
            "bf16_cut_vs_f32_err": bf16_err}


def vision_decode_check(mp, params, cfg, prompts, out, step_logits, gen,
                        dev, extras=None) -> dict:
    """vision-serve's checks past the dense arm and the gates' reach:
    cached decode within LOGIT_TOL of the teacher-forced forward
    (``teacher_forced``, the same image embeddings), the cross caches
    (``vision_cache_check``), the image's reach both ways
    (``vision_reach_check``) and the f32 copy of the first group
    (``vision_f32_check``)."""
    rows, _ = teacher_forced(mp, params, cfg, prompts, out, gen, dev,
                             extras)
    err = max_step_err(step_logits, rows)
    del rows
    torch.cuda.empty_cache()
    check(err <= LOGIT_TOL, f"vision decode vs forward error {err}")
    rec = {"forced_tokens": mp.forced, "decode_vs_forward_err": err,
           **vision_cache_check(params, cfg, prompts, out, dev, extras),
           **vision_reach_check(params, cfg, prompts, step_logits[0], dev,
                                extras),
           **vision_f32_check(params, cfg, prompts, out, dev, extras)}
    emit({"phase": "vision-decode", **rec})
    return rec


def plain_serve_ref(mp, dev, counts) -> dict:
    """The plain serve run that ``model_serve_phase`` makes of ``mp``
    (the same weights, prompts and image embeddings from the same seeds,
    a greedy and a sampled request, then step by step, its prefill
    launching what the chooser resolves at ``mp.prefill_shapes``), as its
    ``serve_ref`` entry: for a mesh path whose cut no serve phase serves
    (the vision cut, mesh-ssm's cuts). Its launches are no path's: the
    mesh path zeroes the counts after it."""
    from repro_torch.serve import engine

    params, cfg, gen = serve_weights(mp, dev)
    per_prefill, _ = router_launches(mp.prefill_shapes(cfg, BATCH * PROMPT),
                                     torch.bfloat16, dev)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    extras = mp.images(cfg, gen, dev) if mp.images else {}
    out = engine.generate(params, cfg, prompts, NEW, extras=extras,
                          device=dev)
    sampled = engine.generate(
        params, cfg, prompts, NEW, extras=extras, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2),
        temperature=1.0)
    step_logits, prefill_ms, decode_ms = serve_step_by_step(
        params, cfg, prompts, out, dev, sum(per_prefill.values()), counts,
        extras)
    ref = serve_ref(prompts, out, sampled, step_logits, prefill_ms,
                    decode_ms, extras)
    del params, step_logits
    torch.cuda.empty_cache()
    return ref


VISION_PATH = ModelPath(
    tag="vision", arch=VISION_ARCH, perturb=vision_perturb_,
    # no projection of a prefill routes to a kernel: wk/wv and the image
    # K/V have n = 1,024, past MAX_SKINNY
    prefill_shapes=lambda cfg, rows: [], decode_gemms=vision_decode_gemms,
    reach=zeroed(vision_gates),
    reach_what="both gates of every cross layer zeroed",
    decode_check=vision_decode_check, forced=PROMPT + NEW, n_micro=4,
    micro_downs=lambda cfg: 0, leaves=("embed.table", "lm_head.table"),
    train_launches=VISION_TRAIN_LAUNCHES, images=vision_images,
    limit_s=VISION_SERVE_MAX_S)
# vision-train and mesh-vision: the one-group cut.
VISION_CUT_PATH = VISION_PATH._replace(arch=VISION_CUT,
                                       limit_s=VISION_TRAIN_MAX_S)
# mesh-ssm's serve: rwkv6 and zamba2 at full width and cut depth (rwkv6 8
# of its 24 layers; zamba2 14 of 38: two groups with their shared block
# and LoRAs, and the two tail Mamba2 layers), each held against a plain
# serve of the same cut (``plain_serve_ref``), to keep the script within
# its call's limit; rwkv-serve and zamba-serve serve the full depth.
SSM_MESH_CUTS = {"rwkv6-1.6b-8l": (RWKV_ARCH, 8),
                 "zamba2-1.2b-14l": (ZAMBA_ARCH, 14)}
RWKV_MESH_PATH = RWKV_PATH._replace(arch="rwkv6-1.6b-8l")
ZAMBA_MESH_PATH = ZAMBA_PATH._replace(arch="zamba2-1.2b-14l")


# ---------------------------------------------------------------------------
# The dist phase: the shard_map executors, tree TSQR and sharded PowerSGD
# in a world of one under NCCL
# ---------------------------------------------------------------------------

DIST_WKWV = (8192, 4096, 256)     # chatglm3-6b's wk/wv, bf16
DIST_Q = (65024, 4096, 4)         # PowerSGD's P and Q of embed / lm_head
# (tag, orth, compress): the sharded PowerSGD arms.
DIST_ARMS = (("gram_schmidt", "gram_schmidt", "none"),
             ("tsqr", "tsqr", "none"), ("int8", "gram_schmidt", "int8"))
# tsmm_t's reduce modes with the executor pinned for each.
DIST_REDUCES = (("psum", "shard_map"), ("none", "shard_map"),
                ("psum_scatter", "shard_map-scatter"))


def dist_launches(kind, shape, dtype, pol, dev) -> dict:
    """The launches one dispatch of ``kind`` at ``shape`` resolves to under
    ``pol`` on the card: the chooser's S (``ops.resolve_params``), the
    split kernel past S = 1 and the epilogue where it runs; the int8
    kernels under ``quant="int8"`` (their quantize passes are
    ``expect``'s)."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import ops

    name = kind + ("_q8" if pol.quant == "int8" else "")
    s = ops.resolve_params(kind, *shape, dtype, pol,
                           device=dev).get("splits", 1)
    if s == 1:
        return {name: 1}
    rows, cols = ((shape[0], shape[2]) if kind == "tsm2r"
                  else (shape[1], shape[2]))
    return {f"{name}_split": 1,
            "sum_partials": int(perf_model.reduce_kernel_runs(s, rows,
                                                              cols))}


def add_launches(total: dict, *parts, times: int = 1) -> dict:
    for part in parts:
        for n, v in part.items():
            total[n] = total.get(n, 0) + v * times
    return total


def traced(dev) -> bool:
    """Whether a profiler session sees the device work of one small op
    (the dist line reports it before and after NCCL starts)."""
    x = torch.ones(1024, device=dev)
    return bool(device_events(lambda: x.add_(1), bool, tries=2))


def device_ms_or_none(fn, reps: int = 5):
    """``call_device_ms``, or None where no profiler session sees device
    work (the dist line says so; its CUDA-event times still stand)."""
    def run():
        for _ in range(reps):
            fn()

    fn()
    events = device_events(run, bool)
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def nccl_device_ms(fn) -> dict:
    """The device activity of one collective call (the mean of 5): its
    kernels' and copies' names and their device ms."""
    fn()

    def run():
        for _ in range(5):
            fn()

    events = device_events(run, bool, tries=2)
    return {"device_ms": sum(e.time_range.elapsed_us() for e in events)
            / 5 / 1e3, "events": sorted({e.name[:60] for e in events})}


def dist_phase(dev, gpu, counts, zero_counts, expect) -> tuple:
    """The dist path: a world of one under NCCL (``init_method="file://"``
    on a temporary file) and a one-dim ``("data",)`` mesh. With the
    executors pinned, chatglm3-6b's wk/wv on a ``Shard(0)`` A and a
    replicated B (outer ``shard_map``, inner ``cuda`` tsm2r on the wgmma
    body) and PowerSGD's Q under each reduce mode (an inner tsmt each),
    every output bit-equal to the unsharded dispatch; then
    ``compress_tree_sharded`` over a chatglm3-6b-4l gradient tree (one
    backward, as the train phase makes it) under gram_schmidt, tsqr and
    int8, its gradients and state bit-equal to ``compress_tree``'s, with
    the launches the classifier and the chooser predict. Then times each
    sharded call beside its unsharded counterpart and the NCCL
    collectives' own device time at the factors' shapes (device ms are
    None where no profiler session sees device work; the line reports
    whether one did before and after NCCL started). Then, in the same
    world, the mesh path's serve and pipeline runs (``mesh_serve``).
    Then the mesh-ssm, mesh-moe, mesh-hubert and mesh-vision phases
    (``mesh_models_phase``). Returns the dist path's launch counts, the
    mesh path's and the mesh-ssm, mesh-moe, mesh-hubert and mesh-vision
    paths'."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    profiler = {"before_nccl": traced(dev)}
    dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        profiler["after_nccl"] = traced(dev)
        launches = _dist_path(dev, gpu, mesh, counts, zero_counts, expect,
                              profiler)
        # The mesh path's serve and pipeline runs, in the same world.
        from repro_torch.launch.mesh import make_host_mesh
        PATH["name"] = "mesh"
        t0 = time.perf_counter()
        mesh_launches = mesh_serve(dev, gpu, make_host_mesh(), counts,
                                   zero_counts, expect)
        MESH_WALL["serve"] = time.perf_counter() - t0
        # rwkv6 and zamba2 (their cuts), then mixtral and deepseek, on
        # DTensor parameters, in the same world.
        register_cuts(SSM_MESH_CUTS)
        model_launches = mesh_models_phase(
            "mesh-ssm", (RWKV_MESH_PATH, ZAMBA_MESH_PATH), MESH_SSM_MAX_S,
            dev, gpu, make_host_mesh(), counts, zero_counts, expect)
        model_launches.update(mesh_models_phase(
            "mesh-moe", (MIXTRAL_PATH, DEEPSEEK_PATH), MESH_MOE_MAX_S, dev,
            gpu, make_host_mesh(), counts, zero_counts, expect))
        model_launches.update(mesh_models_phase(
            "mesh-hubert", (HUBERT_PATH,), MESH_HUBERT_MAX_S, dev, gpu,
            make_host_mesh(), counts, zero_counts, expect))
        model_launches.update(mesh_models_phase(
            "mesh-vision", (VISION_CUT_PATH,), MESH_VISION_MAX_S, dev, gpu,
            make_host_mesh(), counts, zero_counts, expect))
        return launches, mesh_launches, model_launches
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _dist_path(dev, gpu, mesh, counts, zero_counts, expect,
               profiler) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import linalg
    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.data import pipeline
    from repro_torch.models import model
    from repro_torch.optim import powersgd
    from repro_torch.train import train_step

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(28)

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    m, k, n = DIST_WKWV
    a, b = normal((m, k), torch.bfloat16), normal((k, n), torch.bfloat16)
    x = normal(DIST_Q[:2], torch.float32)
    y = normal((DIST_Q[0], DIST_Q[2]), torch.float32)
    a_d = distribute_tensor(a, mesh, [Shard(0)])
    b_d = distribute_tensor(b, mesh, [Replicate()])
    x_d = distribute_tensor(x, mesh, [Shard(0)])
    y_d = distribute_tensor(y, mesh, [Shard(0)])

    # The gradient tree: one backward of chatglm3-6b at 4 layers over the
    # train phase's first batch, in its microbatches.
    cfg = dataclasses.replace(registry.get_config("chatglm3-6b"),
                              n_layers=TRAIN_LAYERS)
    params = model.init(cfg, 0, device=dev)
    params.requires_grad_(True)
    dcfg = pipeline.DataConfig(seed=0, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH,
                               vocab_size=cfg.vocab_size)
    batch = {key: torch.from_numpy(v).to(dev, torch.long)
             for key, v in pipeline.batch_for_step(dcfg, 0).items()}
    _, grads, _ = train_step._microbatch_grads(
        train_step.make_loss_fn(cfg), params, batch, cfg.microbatch)
    del batch

    # The unsharded counterparts, before the path's counts are zeroed.
    ref_mm = tsmm.tsmm(a, b)
    ref_q = tsmm.tsmm_t(x, y)
    arms = {}
    for tag, orth, compress in DIST_ARMS:
        ps = powersgd.PowerSGDConfig(rank=4, orth=orth, compress=compress)
        pol = tsmm.GemmPolicy(quant="int8" if compress == "int8" else "none")
        st0 = powersgd.init(ps, params)
        with tsmm.policy(pol):
            ref = powersgd.compress_tree(ps, grads, st0)
        arms[tag] = (ps, pol, st0, ref)
    params.requires_grad_(False)
    torch.cuda.synchronize()

    # -- the path ----------------------------------------------------------
    zero_counts()
    with recorded() as log:
        with tsmm.policy(executor="shard_map"):
            out_mm = tsmm.tsmm(a_d, b_d)
        mm_log = list(log)
        out_q, q_logs = {}, {}
        for red, executor in DIST_REDUCES:
            start = len(log)
            with tsmm.policy(executor=executor, reduce=red):
                out_q[red] = tsmm.tsmm_t(x_d, y_d)
            q_logs[red] = log[start:]
        sharded = {}
        for tag, (ps, pol, st0, ref) in arms.items():
            with tsmm.policy(pol):
                sharded[tag] = powersgd.compress_tree_sharded(
                    ps, grads, powersgd.shard_state(st0, mesh=mesh,
                                                    axis="data"),
                    mesh=mesh, axis="data")
        torch.cuda.synchronize()
    launches = counts()
    # The path ends here; what follows checks it and times it.

    def route(events, outer, entry, kind, shape):
        outer_ev = [e for e in events if e.executor == outer]
        inner = [e for e in events if e.executor == "cuda"]
        check(len(outer_ev) == 1 and outer_ev[0].launches == ()
              and (outer_ev[0].entry, outer_ev[0].kind, outer_ev[0].shape)
              == (entry, kind, shape) and len(inner) == 1
              and (inner[0].entry, inner[0].kind, inner[0].shape)
              == (entry, kind, shape) and inner[0].launches,
              f"dist {outer} route of {entry} {shape}: {events}")
        return inner[0].launches

    lm = route(mm_log, "shard_map", "mm", "tsm2r", DIST_WKWV)
    check([x.kind for x in lm] == ["tsm2r"]
          and lm[0].params["body"] == "wgmma",
          f"dist wk/wv: {[(x.kind, x.params.get('body')) for x in lm]}")
    check(type(out_mm).__name__ == "DTensor"
          and same_bits(out_mm.to_local(), ref_mm),
          "dist wk/wv differs from the unsharded dispatch")
    q_kernels = {}
    for red, executor in DIST_REDUCES:
        lq = route(q_logs[red], executor, "mmt", "tsmt", DIST_Q)
        q_kernels[red] = [x.kind for x in lq]
        check(lq[0].kind == "tsmt", f"dist Q {red}: {q_kernels[red]}")
        check(tuple(out_q[red].shape) == (DIST_Q[1], DIST_Q[2])
              and same_bits(out_q[red].to_local(), ref_q),
              f"dist Q under reduce={red} differs from the unsharded "
              "dispatch")

    # compress_tree_sharded: bit-equal to compress_tree on one rank.
    metrics = {}
    for tag, (ps, pol, st0, ref) in arms.items():
        out, st, met = sharded[tag]
        r_out, r_st, r_met = ref
        bad = [name for name in grads
               if not torch.equal(out[name], r_out[name])]
        bad += [f"{path}.{key}" for path in r_st for key in ("q", "err")
                if not torch.equal(st[path][key], r_st[path][key])]
        check(not bad and sorted(st) == sorted(r_st)
              == ["embed.table", "lm_head.table"],
              f"dist {tag}: compress_tree_sharded differs from "
              f"compress_tree at {bad[:4]}")
        metrics[tag] = {"sharded": met, "replicated": r_met}
        sharded[tag] = arms[tag] = (ps, pol, st0, None)   # free both

    # The launches the classifier and the chooser predict.
    f32 = tsmm.GemmPolicy()
    leaves = 2
    want = add_launches({}, dist_launches("tsm2r", DIST_WKWV, torch.bfloat16,
                                          f32, dev))
    q_once = dist_launches("tsmt", DIST_Q, torch.float32, f32, dev)
    add_launches(want, q_once, times=len(DIST_REDUCES))
    passes = linalg.default_passes(DIST_Q[0], DIST_Q[2])
    gram = (DIST_Q[0], DIST_Q[2], DIST_Q[2])
    fake_quants = 0
    for tag, (ps, pol, _, _) in arms.items():
        per_leaf = [dist_launches("tsm2r", DIST_Q, torch.float32, pol, dev),
                    dist_launches("tsmt", DIST_Q, torch.float32, pol, dev)]
        if ps.orth == "tsqr":
            per_leaf += [dist_launches("tsmt", gram, torch.float32, pol,
                                       dev)] * passes
            per_leaf += [{"tsm2l": 1}] * passes
        add_launches(want, *per_leaf, times=leaves)
        fake_quants += 2 * leaves * (ps.compress == "int8")
    want = expect(fake_quants=fake_quants, **want)
    check(launches == want, f"dist path launches {launches}, predicted "
          f"{want}")

    # -- times ---------------------------------------------------------------
    def both(fn):
        return {"ms": time_ms(fn), "device_ms": device_ms_or_none(fn)}

    def pinned(executor, red, fn):
        def run():
            with tsmm.policy(executor=executor, reduce=red):
                return fn()
        return run

    times = {"wk/wv": {
        "sharded": both(pinned("shard_map", "psum",
                               lambda: tsmm.tsmm(a_d, b_d))),
        "unsharded": both(lambda: tsmm.tsmm(a, b))}}
    for red, executor in DIST_REDUCES:
        times[f"Q {red}"] = {
            "sharded": both(pinned(executor, red,
                                   lambda: tsmm.tsmm_t(x_d, y_d))),
            "unsharded": both(lambda: tsmm.tsmm_t(x, y))}
    for tag, (ps, pol, st0, _) in arms.items():
        sst = powersgd.shard_state(st0, mesh=mesh, axis="data")

        def sharded_call():
            with tsmm.policy(pol):
                powersgd.compress_tree_sharded(ps, grads, sst, mesh=mesh,
                                               axis="data")

        def replicated_call():
            with tsmm.policy(pol):
                powersgd.compress_tree(ps, grads, st0)

        times[f"compress {tag}"] = {"sharded": both(sharded_call),
                                    "unsharded": both(replicated_call)}
    group = mesh.get_group("data")
    p_buf = torch.ones((DIST_Q[0], DIST_Q[2]), device=dev)
    q_buf = torch.ones((DIST_Q[1], DIST_Q[2]), device=dev)
    q_out = torch.empty_like(q_buf)
    nccl = {"all_reduce P": nccl_device_ms(
                lambda: dist.all_reduce(p_buf, group=group)),
            "reduce_scatter_tensor Q": nccl_device_ms(
                lambda: dist.reduce_scatter_tensor(q_out, q_buf,
                                                   group=group))}
    emit({"phase": "dist", "world": dist.get_world_size(),
          "backend": dist.get_backend(), "mesh": list(mesh.mesh_dim_names),
          "wk_wv": list(DIST_WKWV), "q": list(DIST_Q),
          "q_kernels": q_kernels, "tsqr_passes": passes,
          "launches": {n: v for n, v in launches.items() if v},
          "times": times, "nccl": nccl, "powersgd_metrics": metrics,
          "profiler_sees_device": profiler,
          "wall_s": time.perf_counter() - t_phase, "gpu": gpu})
    del grads, arms, sharded, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The mesh path: chatglm3-6b on DTensor parameters, GPipe, --distributed
# ---------------------------------------------------------------------------

# What the plain serve phases leave for the mesh paths to hold their runs
# against, by path tag ("glm", "rwkv", "zamba"; ``serve_ref``), and what
# the launch phase leaves: each launch run's final loss.
SERVE_REF: dict = {}
LAUNCH_LOSS: dict = {}
MESH_WALL: dict = {}
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 4, 4, 2
MESH_MAX_S = 120.0


def placed_as(mesh, tree, specs) -> list:
    """The entries of ``tree`` (name -> tensor) that are not DTensors in
    the placements ``specs`` (name -> spec) give them."""
    from repro_torch.distributed import sharding
    return [n for n, t in tree.items() if type(t).__name__ != "DTensor"
            or list(t.placements) != sharding.placements(mesh, specs[n])]


def cache_misplaced(cfg, mesh, cache) -> list:
    """The entries of ``cache`` (``model.init_cache``'s list) that do not
    lie where ``sharding.cache_specs`` puts them."""
    from repro_torch.distributed import sharding
    specs = sharding.cache_specs(cfg, mesh, cache)
    return [f"{i}.{k}" for i, (entry, spec) in enumerate(zip(cache, specs))
            for k in placed_as(mesh, entry, spec)]


def mesh_serve_check(name, cfg, params, ref, mesh, dev, counts,
                     zero_counts, expect, shapes, body,
                     decode_gemms, plain_prefill=None) -> tuple:
    """A model's serve on DTensor parameters, held against its plain serve
    run ``ref`` (a ``SERVE_REF`` entry). ``params`` are placed in place by
    ``sharding.make_param_specs`` on ``mesh``; then, from zeroed counts,
    ``generate(sharded_projections=True)`` serves the plain run's prompts
    (and its image embeddings, placed by ``batch_specs``) for NEW greedy
    tokens and one request sampled at temperature 1 from
    its seed, and ``make_serve_fns(sharded_projections=True)`` with a
    cache from ``init_cache(mesh=)`` runs a prefill and NEW - 1 decode
    steps of the greedy tokens, timed as ``serve_step_by_step`` times the
    plain run (host clock, a synchronize after the prefill and after the
    last step). Checks: tokens, sampled tokens and every step's logits
    bit-equal to the plain run's; each prefill launching what the chooser
    resolves at ``shapes`` (tsm2r on ``body`` at its S), each decode step
    ``decode_gemms`` dense projections; every cache entry where
    ``cache_specs`` puts it after the prefill and after the last decode
    step, and the parameters still in their placements. Then two decode
    steps under ``torch.profiler`` (None where the trace came back
    empty); with ``plain_prefill`` (the plain prefill's ``PROFILES``
    entry) one prefill on a fresh cache under it too, its device time by
    class beside the plain one's. Returns (the launches, the specs, the
    line's fields)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    from repro_torch.serve import engine

    specs = sharding.make_param_specs(cfg, params, mesh)
    sharding.named(mesh, specs, params)
    prompts, out_ref = ref["prompts"].to(dev), ref["out"].to(dev)
    extras = {k: v.to(dev) for k, v in ref["extras"].items()}
    per_prefill, splits = router_launches(shapes, torch.bfloat16, dev)
    torch.cuda.synchronize()
    zero_counts()
    with recorded() as log:
        t0 = time.perf_counter()
        out = engine.generate(params, cfg, prompts, NEW, extras=extras,
                              device=dev, sharded_projections=True)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    greedy_launches = counts()
    sampled = engine.generate(
        params, cfg, prompts, NEW, extras=extras, device=dev,
        sharded_projections=True,
        generator=torch.Generator(device=dev).manual_seed(2),
        temperature=1.0)
    with recorded():
        prefill_step, decode_step = engine.make_serve_fns(
            cfg, sharded_projections=True)
        cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev,
                                 mesh=mesh)
        host = {"tokens": prompts, **extras}
        batch = sharding.named(mesh, sharding.batch_specs(cfg, mesh, host),
                               dict(host))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, batch, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        misplaced = {"prefill": cache_misplaced(cfg, mesh, cache)}
        step_logits = [logits]
        t0 = time.perf_counter()
        for i in range(1, NEW):
            logits, cache = decode_step(params, out[:, i - 1:i],
                                        PROMPT + i - 1, cache)
            step_logits.append(logits)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
        misplaced["decode"] = cache_misplaced(cfg, mesh, cache)
    launches = counts()
    # Two decode steps again under the profiler, as ``profile_serve``
    # takes the plain path's: what the card does of a mesh decode step.
    rec = device_profile(lambda: [
        decode_step(params, out[:, i - 1:i], PROMPT + i - 1, cache)
        for i in (1, 2)])
    profile = {"decode": {k: rec[k] for k in ("device_busy_ms",
                                              "device_kernels", "runs")}
               if rec["device_kernels"] else None}
    if profile["decode"]:
        profile["decode"]["busy_share"] = rec["device_busy_ms"] / (
            2 * decode_ms)
    del cache
    if plain_prefill is not None:
        cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev,
                                 mesh=mesh)
        rec = device_profile(lambda: prefill_step(params, batch, cache))
        del cache
        check(rec["device_kernels"] > 0, f"{name}: an empty prefill trace")
        profile["prefill"] = {
            "device_busy_ms": rec["device_busy_ms"],
            "device_kernels": rec["device_kernels"], "runs": rec["runs"],
            "busy_share": rec["device_busy_ms"] / prefill_ms,
            "by_class_ms": _class_ms(rec["by_category_ms"]),
            "by_category_ms": rec["by_category_ms"],
            "plain": {"device_busy_ms": plain_prefill["device_busy_ms"],
                      "unprofiled_ms": plain_prefill["unprofiled_ms"],
                      "by_class_ms": _class_ms(
                          plain_prefill["by_category_ms"])}}

    bodies = prefill_route_check(name, log, shapes, splits, body,
                                 BATCH * PROMPT)
    decode_events = [e for e in log if e.shape[0] == BATCH]
    check(len(decode_events) == (NEW - 1) * decode_gemms and all(
        e.executor == "torch-dense" for e in decode_events),
        f"every {name} decode projection goes to torch-dense: "
        f"{len(decode_events)}")
    check(greedy_launches == expect(**per_prefill), f"{name} greedy "
          f"request launches {greedy_launches}, want {per_prefill}")
    check(launches == expect(**{k: 3 * v for k, v in per_prefill.items()}),
          f"{name} serve launches {launches}, want 3 x {per_prefill}")
    check(torch.equal(out, out_ref), f"{name} tokens differ from the plain "
          f"serve phase's")
    check(torch.equal(sampled.cpu(), ref["sampled"]), f"{name} sampled "
          f"tokens differ from the plain serve phase's")
    bad = [i for i, (a, b) in enumerate(zip(step_logits,
                                            ref["step_logits"]))
           if not same_bits(a.full_tensor(), b.to(dev))]
    check(len(step_logits) == len(ref["step_logits"]) == NEW and not bad,
          f"{name} logits differ from the plain serve phase's at steps "
          f"{bad}")
    check(not misplaced["prefill"] and not misplaced["decode"],
          f"{name} caches out of their specs' placements: {misplaced}")
    check(not placed_as(mesh, dict(params.named_parameters()), specs),
          f"{name} parameters left their placements")
    return launches, specs, {
        "prefill_ms": prefill_ms, "plain_prefill_ms": ref["prefill_ms"],
        "decode_ms_per_step": decode_ms,
        "plain_decode_ms_per_step": ref["decode_ms"],
        "greedy_request_s": greedy_s, "launches_per_prefill": per_prefill,
        "tsm2r_body": bodies, "profile": profile,
        "bit_equal": {"tokens": True, "logits": True, "sampled": True}}


def mesh_serve(dev, gpu, mesh, counts, zero_counts, expect) -> dict:
    """mesh-serve: chatglm3-6b at published width and depth (bf16, seed 0)
    on DTensor parameters on the ``(1, 1)`` ``("data", "model")`` mesh,
    held against the serve phase (``mesh_serve_check``): tokens, sampled
    tokens and every step's logits bit for bit, each prefill launching
    tsm2r 2 x n_layers times (wk, wv) on the wgmma body, prefill ms and
    decode ms a step beside the plain path's. First, on the same weights
    as plain tensors, the pipeline run: the 28 layers as PIPE_STAGES GPipe
    stages over PIPE_MICRO microbatches, bit-equal to the sequential
    forward, with the tsm2r launches the schedule predicts. Returns both
    runs' launch counts."""
    from repro_torch.configs import registry
    from repro_torch.distributed import pipeline, sharding
    from repro_torch.models import blocks, model

    t_phase = time.perf_counter()
    cfg = registry.get_config("chatglm3-6b")
    per_prefill = 2 * cfg.n_layers
    params = model.init(cfg, seed=0, device=dev)

    # -- pipeline: the 28 layers as 4 stages of 7 (plain tensors) ---------
    gen = torch.Generator(device=dev).manual_seed(29)
    tokens = torch.randint(0, cfg.vocab_size,
                           (PIPE_MICRO * PIPE_ROWS, PROMPT), generator=gen,
                           device=dev)
    with torch.no_grad():
        micro = params.embed.table[tokens].view(
            PIPE_MICRO, PIPE_ROWS, PROMPT, cfg.d_model)
        stages = pipeline.split_stages(list(params.layers), PIPE_STAGES)
        stage_fn = pipeline.make_stage_fn(
            lambda lp, x: blocks.block_fwd(lp, x, cfg)[0])
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with recorded():
            piped = pipeline.pipeline_apply(stage_fn, stages, micro)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        pipe_launches = counts()
        # The prediction from the schedule: every microbatch passes every
        # stage once (bubbles skipped), 2 tsm2r (wk, wv) a layer.
        want_pipe = expect(tsm2r=PIPE_MICRO * cfg.n_layers * 2)
        t0 = time.perf_counter()
        seq = torch.stack([stage_fn(list(params.layers), mb)
                           for mb in micro])
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    check(pipe_launches == want_pipe, f"pipeline launches {pipe_launches}, "
          f"predicted {want_pipe}")
    check(same_bits(piped, seq), "pipeline output differs from the "
          "sequential forward")
    emit({"phase": "mesh", "line": "pipeline", "stages": PIPE_STAGES,
          "layers_a_stage": cfg.n_layers // PIPE_STAGES,
          "microbatches": PIPE_MICRO, "rows": PIPE_ROWS, "seq": PROMPT,
          "ticks": PIPE_MICRO + PIPE_STAGES - 1, "pipeline_s": pipe_s,
          "sequential_s": seq_s, "bit_equal": True,
          "launches": {n: v for n, v in pipe_launches.items() if v},
          "gpu": gpu})
    del micro, stages, piped, seq, tokens

    # -- mesh-serve --------------------------------------------------------
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    launches, specs, served = mesh_serve_check(
        "mesh-serve", cfg, params, SERVE_REF.pop("glm"), mesh, dev, counts,
        zero_counts, expect, [(BATCH * PROMPT, cfg.d_model, kv)] * per_prefill,
        "wgmma", 7 * cfg.n_layers,
        plain_prefill=PROFILES.get(("chatglm3-6b", "prefill")))
    emit({"phase": "mesh", "line": "mesh-serve", "model": cfg.name,
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "placements": {n: [repr(p) for p in sharding.placements(mesh, sp)]
                         for n, sp in specs.items() if n.startswith(
                             ("embed", "lm_head", "layers.0."))},
          **served, "launches": {n: v for n, v in launches.items() if v},
          "wall_s": time.perf_counter() - t_phase, "gpu": gpu})
    del params
    torch.cuda.empty_cache()
    return add_launches(dict(launches), pipe_launches)


def mesh_launch(gpu, counts, zero_counts) -> dict:
    """mesh-launch: ``repro_torch.launch.train.main`` with
    ``--distributed`` in a world of one, in this process under torchrun's
    environment (RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, a free MASTER_PORT;
    the launcher starts and destroys its NCCL group), at the launch
    phase's ``LAUNCH_ARCH`` and argv. Run B (``--chaos-step 1``) must roll
    back once and end on the launch phase's B loss bit for bit; then R1
    (1 step, ``--ckpt-every 1``) and R2 (resumed through
    ``elastic.restore_state`` to step 3) must end on its A loss bit for
    bit. Each run launches tsm2r 66 and tsmt 2 times a step it executed.
    Returns the runs' launch counts."""
    import shutil
    import socket
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.launch import train as launcher

    cfg = dataclasses.replace(registry.get_config("chatglm3-6b"),
                              name=LAUNCH_ARCH, n_layers=TRAIN_LAYERS)
    registry._MODULES[LAUNCH_ARCH] = type(
        "M", (), {"CONFIG": cfg, "smoke": staticmethod(lambda: cfg)})
    per_step = {"tsm2r": 2 * TRAIN_LAYERS * cfg.microbatch * 2 + 2,
                "tsmt": 2}
    base = ["--arch", LAUNCH_ARCH, "--global-batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--powersgd-rank", "4",
            "--log-every", "1", "--distributed"]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    runs = {"B": (["--steps", "3", "--chaos-step", "1"], "B", (1, 4)),
            "R1": (["--steps", "1", "--ckpt-dir", ckpt_dir,
                    "--ckpt-every", "1"], None, (0, 1)),
            "R2": (["--steps", "3", "--ckpt-dir", ckpt_dir,
                    "--ckpt-every", "100"], "A", (0, 2))}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    total, out = {n: 0 for n in counts()}, {}
    try:
        for tag, (extra, want_loss, (retries, executed)) in runs.items():
            torch.cuda.empty_cache()
            zero_counts()
            t0 = time.perf_counter()
            with launch_timers() as log, recorded():
                res = launcher.main(base + extra)
            wall = time.perf_counter() - t0
            launches = counts()
            for n, v in launches.items():
                total[n] += v
            steps = [r["s"] * 1e3 for r in log if r["what"] == "step"]
            want = {n: 0 for n in launches}
            want["tsm2r"] = per_step["tsm2r"] * len(steps)
            want["tsmt"] = per_step["tsmt"] * len(steps)
            out[tag] = {"argv": base + extra, "result": res,
                        "steps_executed": len(steps), "step_ms": steps,
                        "wall_s": wall,
                        "calls": {r["what"]: r["s"] for r in log
                                  if r["what"] != "step"},
                        "launches": {n: v for n, v in launches.items()
                                     if v}}
            check(launches == want, f"mesh-launch run {tag} launches "
                  f"{launches}, want {want}")
            check((res["fault_retries"], len(steps)) == (retries, executed),
                  f"mesh-launch run {tag}: {res}, executed {len(steps)}")
            if want_loss is not None:
                check(res["final_loss"] == LAUNCH_LOSS[want_loss],
                      f"mesh-launch run {tag} final loss "
                      f"{res['final_loss']!r} is not the launch phase's "
                      f"{want_loss} {LAUNCH_LOSS[want_loss]!r}")
            check(not torch.distributed.is_initialized(), "the launcher "
                  "left its process group up")
        meminfo = dict(line.split(":", 1) for line in
                       Path("/proc/meminfo").read_text().splitlines())
        emit({"phase": "mesh", "line": "mesh-launch", "runs": out,
              "mem_available_gb": int(meminfo["MemAvailable"].split()[0])
              * 1024 / 1e9,
              "launch_phase_loss": dict(LAUNCH_LOSS),
              "launch_phase_step_ms": LAUNCH_LOSS.get("step_ms"),
              "bit_equal": {"B": True, "R2": True}, "gpu": gpu})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        registry._MODULES.pop(LAUNCH_ARCH, None)
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# The mesh-ssm and mesh-moe phases: rwkv6-1.6b, zamba2-1.2b, mixtral-8x7b
# and deepseek-v3-671b on DTensor parameters
# ---------------------------------------------------------------------------

# The train arms: full width, cut in depth (rwkv6 4 layers; zamba2 6, one
# group with its shared block and both LoRAs; mixtral 2, the mixtral-train
# cut), MESH_STEPS steps; and the launches a step they must predict where
# the cut is a train phase's (mixtral's). deepseek has none (one MoE
# layer's AdamW state is ~140 GB).
MESH_TRAIN = {"rwkv": (4, None), "zamba": (6, None),
              "mixtral": (2, MIXTRAL_TRAIN_LAUNCHES), "hubert": (2, None),
              "vision": (5, VISION_TRAIN_LAUNCHES)}
MESH_STEPS = 2
MESH_WALLS: dict = {}
# About 1.5x the phase's first run in the whole script with its serve
# check at full depth: 56.3 s on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6); 46.5 s with the serve cut (``SSM_MESH_CUTS``).
MESH_SSM_MAX_S = 85.0
# About 1.5x the phase's first run in the whole script with every check:
# 28.0 s on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6).
MESH_MOE_MAX_S = 42.0


def serve_weights(mp, dev):
    """The weights ``model_serve_phase`` serves for ``mp`` (and the mesh
    phases build again on the card): its config's parameters from seed 0,
    perturbed by ``mp.perturb`` from a generator seeded 0. Returns (the
    parameters, the config, the generator, which draws the prompts
    next)."""
    from repro_torch.configs import registry
    from repro_torch.models import model

    cfg = registry.get_config(mp.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(cfg, seed=0, device=dev)
    mp.perturb(params, cfg, gen)
    return params, cfg, gen


def mesh_train_arms(mp, dev, mesh):
    """The train arms of a mesh path: ``mp``'s model at full width and
    ``MESH_TRAIN`` depth, bf16, from seed 0 perturbed by
    ``mp.perturb``, PowerSGD rank 4, TRAIN_BATCH x TRAIN_SEQ tokens in the
    config's microbatches, remat on, MESH_STEPS steps. Runs the plain
    arm twice here (is it bit-reproducible on this card?), keeping the
    first run's parameters and the second's distance from them, and
    returns the mesh arm as a callable, for the path's counted window:
    the same state and batches on DTensors placed by ``make_param_specs``
    (the moments by ``make_opt_specs``, PowerSGD's state as the launcher
    places it), through ``make_train_step(acc_shardings=, mesh=)``."""
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as launcher
    from repro_torch.optim import adamw, powersgd, schedule
    from repro_torch.train import train_step

    cfg = dataclasses.replace(registry.get_config(mp.arch),
                              n_layers=MESH_TRAIN[mp.tag][0])
    n_micro = cfg.microbatch
    dcfg = pipeline.DataConfig(
        seed=0, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        vocab_size=cfg.vocab_size,
        mode="frames" if cfg.input_mode == "frames" else "tokens",
        frame_dim=cfg.frame_dim, vision_seq=cfg.vision_seq,
        vision_dim=cfg.vision_dim)
    opt = adamw.AdamWConfig(
        lr=schedule.linear_warmup_cosine(3e-3, 20, TRAIN_STEPS),
        weight_decay=0.1)
    ps = powersgd.PowerSGDConfig(rank=4)
    batches = [launcher.to_tensors(pipeline.batch_for_step(dcfg, i), dev)
               for i in range(MESH_STEPS)]

    def fresh_state():
        state = train_step.init_train_state(0, cfg, opt, device=dev)
        mp.perturb(state["params"], cfg,
                   torch.Generator(device=dev).manual_seed(0))
        state["extra"] = powersgd.init(ps, state["params"])
        return state

    def run(state, step, place=lambda b: b):
        losses, logs, ms = [], [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded() as log:
                state, m = step(state, place(dict(b)))
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            check(bool(m["step_ok"]), f"mesh-{mp.tag} train step not ok")
            logs.append(log)
        return state, losses, logs, ms

    def compress(g, st):
        return powersgd.compress_tree(ps, g, st)

    plain = []
    for _ in range(2):
        state, losses, _, ms = run(fresh_state(), train_step.make_train_step(
            cfg, opt, n_micro=n_micro, grad_transform=compress))
        params = {n: p.detach() for n, p in
                  state["params"].named_parameters()}
        if plain:       # the second run: only its distance from the first
            params = params_distance(params, plain[0]["params"])
        else:
            params = {n: p.clone() for n, p in params.items()}
        plain.append({"losses": losses, "ms": ms, "params": params})
        shapes = {path: st["err"].shape
                  for path, st in state["extra"].items()}
        del state
        torch.cuda.empty_cache()

    def mesh_arm():
        state = fresh_state()
        specs = sharding.make_param_specs(cfg, state["params"], mesh)
        sharding.named(mesh, {"params": specs,
                              "opt": sharding.make_opt_specs(specs)}, state)
        sharding.named(mesh, launcher._powersgd_specs(state["extra"], specs),
                       state["extra"])
        step = train_step.make_train_step(
            cfg, opt, n_micro=n_micro, grad_transform=compress,
            acc_shardings=sharding.named(mesh, specs), mesh=mesh)
        state, losses, logs, ms = run(state, step, lambda b: sharding.named(
            mesh, sharding.batch_specs(cfg, mesh, b), b))
        params = dict(state["params"].named_parameters())
        return {"losses": losses, "ms": ms, "logs": logs,
                "misplaced": placed_as(mesh, params, specs),
                "gap": params_distance({n: p.to_local().detach()
                                        for n, p in params.items()},
                                       plain[0]["params"])}

    return cfg, ps, shapes, plain, mesh_arm


def params_distance(a: dict, b: dict) -> float:
    """The largest absolute difference over every leaf of two parameter
    trees (name -> tensor)."""
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def tree_check_prediction(params, dev) -> tuple:
    """What one ``abft.encode_tree`` over ``params`` launches, as the
    classifier and the chooser on this card predict it: the checksum of
    every leaf of at least ``abft.MIN_LEAF`` elements, ``[m, cols]^T .
    [m, 2]`` in f32 (``encode_leaf``), on tsmt, or on tsmt_split at the
    chooser's S (and sum_partials where the split's epilogue runs it),
    unless it classifies dense. Returns (launches, {shape: S} of the
    routed products, their shapes, one a leaf)."""
    from repro_torch.core import perf_model, tsmm
    from repro_torch.ft import abft, named_leaves
    from repro_torch.kernels import ops

    pol = tsmm.GemmPolicy()
    want, splits, shapes = {}, {}, []
    for _, x in named_leaves(params):
        if x.dim() < 1 or x.numel() < abft.MIN_LEAF:
            continue
        shape = (x.shape[0], x.numel() // x.shape[0], 2)
        if tsmm.classify_gemm_t(*shape, pol) == "dense":
            continue
        s = ops.resolve_params("tsmt", *shape, torch.float32, pol,
                               device=dev)["splits"]
        kern = "tsmt" if s == 1 else "tsmt_split"
        want[kern] = want.get(kern, 0) + 1
        if s > 1 and perf_model.reduce_kernel_runs(s, shape[1], 2):
            want["sum_partials"] = want.get("sum_partials", 0) + 1
        splits[shape] = s
        shapes.append(shape)
    return want, splits, shapes


def mesh_tree_check(name, params, plain_checksums, want, splits, shapes,
                    counts, expect) -> dict:
    """rwkv6's or hubert's ABFT tree check on its DTensor parameters
    (counted in the path's window): one ``encode_tree``, ``verify_tree`` clean and after
    ``poison_tree``. The checksums must be bit-equal to the plain
    leaves' (``plain_checksums``), ``verify_tree`` must pass, then fail,
    and each of the three encodes must launch what
    ``tree_check_prediction`` predicts (``want``, ``splits``, ``shapes``)
    with the routes it predicts. Returns the line's ``abft`` field."""
    from repro_torch.ft import abft, inject

    before = counts()
    with recorded() as log:
        checksums = abft.encode_tree(params)
        clean, _ = abft.verify_tree(params, checksums)
        inject.poison_tree(params)
        poisoned, _ = abft.verify_tree(params, checksums)
    launches = {n: v - before[n] for n, v in counts().items()}
    bad = [n for n, c in checksums.items()
           if (c is None) != (plain_checksums[n] is None)
           or (c is not None
               and not same_bits(c.full_tensor(), plain_checksums[n]))]
    check(not bad, f"{name} DTensor checksums differ from the plain "
          f"leaves' at {bad[:4]}")
    check(bool(clean) and not bool(poisoned), f"{name} verify_tree: "
          f"clean {bool(clean)}, after poison_tree {bool(poisoned)}")
    check(launches == expect(**{k: 3 * v for k, v in want.items()}),
          f"{name} tree check launches {launches}, predicted {want} an "
          f"encode")
    routed = [e for e in log if e.kind != "dense"]
    check(sorted(e.shape for e in routed) == sorted(shapes * 3)
          and all(e.kind == "tsmt" and e.executor == "cuda"
                  and all(lm.splits == splits[e.shape]
                          for lm in e.launches if lm.kind != "reduce")
                  for e in routed),
          f"{name} tree check routes {routed[:2]}")
    return {"leaves": sum(c is not None for c in checksums.values()),
            "bit_equal": True, "clean_ok": True, "poisoned_ok": False,
            "launches_per_encode": want,
            "splits": {str(list(k)): v for k, v in splits.items()},
            "launches": {n: v for n, v in launches.items() if v}}


def mesh_model_path(phase, mp, dev, gpu, mesh, counts, zero_counts,
                    expect) -> dict:
    """One model of a mesh phase (``mp``: ``RWKV_MESH_PATH``,
    ``ZAMBA_MESH_PATH``, ``MIXTRAL_PATH``, ``DEEPSEEK_PATH``,
    ``HUBERT_PATH``, ``VISION_CUT_PATH``), in the world of one. First, not
    counted: the plain train arms (``mesh_train_arms``, where
    ``MESH_TRAIN`` names the model), and where no serve phase left a
    ``SERVE_REF`` entry (the SSM and vision cuts) the plain serve run
    (``plain_serve_ref``). Then the path,
    from zeroed counts to the read after its last step. Serve: the weights
    ``model_serve_phase`` (hubert: ``hubert_serve_phase``) served, built
    again on the card (``serve_weights``), on DTensors on the ``(1, 1)``
    ``("data", "model")`` mesh, held against that serve run's
    ``SERVE_REF`` entry by ``mesh_serve_check`` (each prefill launching
    ``mp.prefill_shapes`` at the chooser's S on ``mp.body``), or for an
    encoder by ``mesh_encode_check`` (forward and prefill, no decode);
    rwkv6 and hubert also take the ABFT tree check on their DTensor
    parameters (``mesh_tree_check``); then the serve weights are
    freed. Train: the mesh arm, each step's losses and every
    parameter bit-equal to the plain arm's (or, where the plain arm does
    not repeat itself bit for bit, within its two runs' distance),
    launching what ``train_prediction`` predicts (for mixtral
    ``MIXTRAL_TRAIN_LAUNCHES`` a step), the parameters in their
    placements after the steps. Returns the path's launch counts."""
    from repro_torch.distributed import sharding
    from repro_torch.ft import abft

    name = f"mesh-{mp.tag}"
    t_phase = time.perf_counter()
    ref = SERVE_REF.pop(mp.tag, None)
    train_line, train = {}, None
    if mp.tag in MESH_TRAIN:
        train_cfg, ps, shapes, plain, mesh_arm = mesh_train_arms(mp, dev,
                                                                 mesh)
        train_want, factors, down, s_down, per_step_down = train_prediction(
            mp, train_cfg, shapes, ps, TRAIN_BATCH * TRAIN_SEQ, dev)
        fixed = MESH_TRAIN[mp.tag][1]
        check(fixed is None or train_want == fixed, f"{name} predicted "
              f"launches {train_want}, not {fixed}")
    torch.cuda.reset_peak_memory_stats()
    if ref is None:
        # no serve phase served this cut: its plain run, here, uncounted
        ref = plain_serve_ref(mp, dev, counts)
    params, cfg, _ = serve_weights(mp, dev)
    tree_check = mp.tag in ("rwkv", "hubert")
    if tree_check:
        plain_checksums = abft.encode_tree(params)
        abft_want, abft_splits, abft_shapes = tree_check_prediction(params,
                                                                    dev)

    # -- the path ----------------------------------------------------------
    if mp.encoder:
        serve_launches, specs, served = mesh_encode_check(
            name, cfg, params, ref, mesh, dev, counts, zero_counts, expect)
    else:
        serve_launches, specs, served = mesh_serve_check(
            name, cfg, params, ref, mesh, dev, counts, zero_counts, expect,
            mp.prefill_shapes(cfg, BATCH * PROMPT), mp.body,
            mp.decode_gemms(cfg))
    placements = {n: [repr(p) for p in sharding.placements(mesh, sp)]
                  for n, sp in specs.items()
                  if n.startswith(("embed", "lm_head", "frame_proj",
                                   "layers.0.", "tail.0.",
                                   "groups.0.mamba.0.", "groups.0.lora",
                                   "groups.0.self.0.", "groups.0.cross."))}
    abft_line = ({"abft": mesh_tree_check(
        name, params, plain_checksums, abft_want, abft_splits, abft_shapes,
        counts, expect)} if tree_check else {})
    serve_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    if mp.tag in MESH_TRAIN:
        before = counts()
        train = mesh_arm()
        train_launches = {n: v - before[n] for n, v in counts().items()}
    launches = counts()
    # The path ends here; what follows only checks it.

    if train is not None:
        plain_gap = plain[1]["params"]
        plain_repeat = (plain[0]["losses"] == plain[1]["losses"]
                        and plain_gap == 0.0)
        if plain_repeat:
            check(train["losses"] == plain[0]["losses"]
                  and train["gap"] == 0.0,
                  f"{name} train arm differs from the plain arm: losses "
                  f"{train['losses']} vs {plain[0]['losses']}, parameters "
                  f"{train['gap']} apart")
        else:
            loss_gap = max(abs(a - b) for a, b in zip(plain[0]["losses"],
                                                      plain[1]["losses"]))
            check(max(abs(a - b) for a, b in zip(train["losses"],
                                                 plain[0]["losses"]))
                  <= loss_gap and train["gap"] <= plain_gap,
                  f"{name} train arm beyond the plain arm's own spread: "
                  f"{train['losses']} vs {plain[0]['losses']} and "
                  f"{plain[1]['losses']}, {train['gap']} vs {plain_gap}")
        check(not train["misplaced"], f"{name} train left parameters out "
              f"of their placements: {train['misplaced'][:4]}")
        want_step = expect(**train_want)
        check(train_launches == {n: v * MESH_STEPS
                                 for n, v in want_step.items()},
              f"{name} train launches {train_launches}, predicted "
              f"{train_want} a step")
        p_bodies = [train_step_routes(f"{name} train step {i + 1}", log, mp,
                                      down, s_down, per_step_down, factors)
                    for i, log in enumerate(train["logs"])]
        train_line = {"train": {
            "layers": train_cfg.n_layers, "n_micro": train_cfg.microbatch,
            "steps": MESH_STEPS, "losses": train["losses"],
            "plain_losses": [a["losses"] for a in plain],
            "step_ms": train["ms"],
            "plain_step_ms": [a["ms"] for a in plain],
            "plain_repeats_bit_for_bit": plain_repeat,
            "plain_runs_apart": plain_gap, "mesh_vs_plain": train["gap"],
            "launches_per_step": {n: v for n, v in want_step.items() if v},
            "factors": factors, "p_bodies": p_bodies}}
    emit({"phase": phase, "line": name, "model": cfg.name,
          "layers": cfg.n_layers,
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "placements": placements, **served,
          "serve_peak_mem_gb": serve_peak_gb, **train_line, **abft_line,
          "launches": {n: v for n, v in launches.items() if v},
          "wall_s": time.perf_counter() - t_phase, "gpu": gpu})
    del train, ref
    torch.cuda.empty_cache()
    return launches


def mesh_models_phase(phase, paths, limit, dev, gpu, mesh, counts,
                      zero_counts, expect) -> dict:
    """A mesh phase (``phase``: mesh-ssm, mesh-moe, mesh-hubert,
    mesh-vision) over
    ``paths``
    (``mesh_model_path`` each), in the dist path's world of one; each
    model's run its own path (``mesh_<tag>``: counts zeroed before, read
    after). The phase must finish within ``limit`` seconds. Returns the
    paths' launch counts."""
    out, wall = {}, MESH_WALLS.setdefault(phase, {})
    for mp in paths:
        PATH["name"] = f"mesh_{mp.tag}"
        t0 = time.perf_counter()
        out[PATH["name"]] = mesh_model_path(phase, mp, dev, gpu, mesh,
                                            counts, zero_counts, expect)
        wall[mp.tag] = time.perf_counter() - t0
    total = sum(wall.values())
    emit({"phase": phase, "line": "summary", "wall_s": wall,
          "total_s": total, "limit_s": limit,
          "launches": {p: {n: v for n, v in c.items() if v}
                       for p, c in out.items()}, "gpu": gpu})
    check(total < limit, f"the {phase} phase took {total} s, over {limit}")
    return out


# The autotune phase's shapes (``core/autotune.py``): the main paths'
# tsm2r, tsmt and tsm2l calls, calibrated a dtype at a time at the card's
# ``device_spec`` and merged into one table. f32: PowerSGD's P of
# chatglm3-6b's embed and lm_head [65024,4096]·[4096,4] and of
# llama-3.2-vision's [128256,4096]·[4096,4], zamba2's P
# [2048,2048]·[2048,4] and [8192,2048]·[2048,4], Q [65024,4096]^T
# [65024,4], the ABFT stage [4096,256]^T [4096,2], hubert's tree check
# [5120,1280]^T [5120,2], mesh-rwkv's tree check [2048,64]^T [2048,2] and
# the TSQR apply [65024,4]·[4,4]; bf16: mixtral's router
# [8192,4096]·[4096,8] and [4096,4096]·[4096,8], and wk/wv
# [8192,4096]·[4096,256] (one candidate: S = 1); int8 (f32 operands
# under quant="int8"): P and Q at [65024,4096].
AUTOTUNE_SHAPES = (
    (torch.float32, "none", (("tsm2r", 65024, 4096, 4),
                             ("tsm2r", 128256, 4096, 4),
                             ("tsm2r", 2048, 2048, 4),
                             ("tsm2r", 8192, 2048, 4),
                             ("tsmt", 65024, 4096, 4),
                             ("tsmt", 4096, 256, 2),
                             ("tsmt", 5120, 1280, 2),
                             ("tsmt", 2048, 64, 2),
                             ("tsm2l", 65024, 4, 4))),
    (torch.bfloat16, "none", (("tsm2r", 8192, 4096, 8),
                              ("tsm2r", 4096, 4096, 8),
                              ("tsm2r", 8192, 4096, 256))),
    (torch.float32, "int8", (("tsm2r", 65024, 4096, 4),
                             ("tsmt", 65024, 4096, 4))),
)
AUTOTUNE_REPS = 7
# The phase's limit, about twice its first run in the script (1.86 s on
# an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6, the autotuner).
AUTOTUNE_MAX_S = 4.0
# The sleep-gated timer against the profiler's sum of the call's device
# kernels, where the profiler reads at least this many ms.
AUTOTUNE_PROFILED_MS = 0.1
AUTOTUNE_TIMER_TOL = 0.30


def autotune_phase(dev, gpu, counts, zero_counts, expect) -> dict:
    """Calibrate the split factor on the card at ``AUTOTUNE_SHAPES`` and
    drive the tuned table: one ``autotune`` line per record (the winner's
    S beside the chooser's, the sleep-gated timer's device time beside
    the profiler's ``call_device_ms`` of the winner), a fit line (the
    merged global fit of ``launch_s`` and ``hbm_bw``, the model's error
    before and after), and the checks: every record contract-clean on the
    card's limits and registered executors, the table equal after a save
    and load, the timer within ``AUTOTUNE_TIMER_TOL`` of the profiler
    where it reads at least ``AUTOTUNE_PROFILED_MS``; then the path, its
    counts zeroed before and read after: each tuned op under
    ``tsmm.policy(tuning_table=table)`` at its record's S and within
    ``TOL`` (atol grown with the depth) of its plain version; and without
    the table every shape resolved and launched at the chooser's S, as
    on every other path. Returns the path's launches."""
    import tempfile

    from repro_torch.analysis import contracts
    from repro_torch.core import autotune, perf_model, tsmm
    from repro_torch.kernels import ops, quant, ref

    t0 = time.perf_counter()
    spec = perf_model.device_spec(perf_model.H100, dev)
    limits = contracts.card_limits(dev)
    known = tuple(tsmm.executors())
    results, cal = [], []
    for dtype, q, shapes in AUTOTUNE_SHAPES:
        res = autotune.calibrate(
            shapes, spec=spec, dtype=dtype, policy=tsmm.GemmPolicy(quant=q),
            device=dev, reps=AUTOTUNE_REPS, warmup=2)
        results.append((dtype, q, res))
        cal.append({"dtype": str(dtype), "quant": q,
                    "error_before": res.error_before,
                    "error_after": res.error_after,
                    "launch_s": res.spec.launch_s, "hbm_bw": res.spec.hbm_bw})
    # One table: every record and bucket fit, and a global fit over all
    # the observations (each calibration's own global cell is per dtype).
    merged = autotune.TuningTable.from_records(
        [r for *_, res in results for r in res.table.records],
        [f for *_, res in results for f in res.table.fits if f.kind != "*"])
    fit = autotune.fit_spec(spec, autotune.observations_from_table(merged))
    table = merged.with_fits([autotune.SpecFit(
        *autotune.GLOBAL_FIT, spec.name, fit.spec.launch_s,
        fit.spec.hbm_bw)])
    emit({"phase": "autotune", "line": "fit", "launch_s": fit.spec.launch_s,
          "hbm_bw": fit.spec.hbm_bw, "data_sheet_launch_s": spec.launch_s,
          "data_sheet_hbm_bw": spec.hbm_bw,
          "error_before": fit.error_before, "error_after": fit.error_after,
          "observations": len(autotune.observations_from_table(merged)),
          "per_dtype": cal, "gpu": gpu})
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "h100_tuning.json"
        table.save(path)
        check(autotune.TuningTable.load(path) == table,
              "the tuning table changed in a save and load")

    gen = torch.Generator(device=dev).manual_seed(35)

    def operands(kind, m, d1, d2, dtype):
        shapes = ((m, d1), (m, d2)) if kind == "tsmt" else ((m, d1), (d1, d2))
        return [torch.empty(sh, device=dev).uniform_(-1, 1, generator=gen)
                .to(dtype) for sh in shapes]

    def op(kind, x, y, pol):
        if kind == "tsmt":
            return tsmm.tsmm_t(x, y, mode="tsmt", policy=pol)
        return tsmm.tsmm(x, y, mode=kind, policy=pol)

    def plain(kind, x, y, q):
        if q == "none":
            return {"tsm2r": ref.tsm2r_ref, "tsm2l": ref.tsm2l_ref,
                    "tsmt": ref.tsmt_ref}[kind](x, y)
        # the quantize pass's plain version too: it is bit-equal to the
        # pass (the quantize phase), and launches no counted kernel
        band = perf_model.Q8_BAND
        x_q, x_s = quant.quantize_blocks_ref(x, band)
        if kind == "tsmt":
            y_q, y_s = quant.quantize_blocks_ref(y, band)
            return ref.tsmt_q8_ref(x_q, y_q, x_s, y_s, band, x.dtype)
        y_q, y_s = quant.quantize_tensor_ref(y)
        return ref.tsm2r_q8_ref(x_q, y_q, x_s, y_s, band, x.dtype)

    cases = []
    for dtype, q, res in results:
        pol = tsmm.GemmPolicy(quant=q)
        for r in res.table.records:
            m, d1, d2 = r.shape
            s = r.params_dict.get("splits")
            pick = dict(r.model_pick).get("splits")
            vios = contracts.check_tuning_record(
                r.kind, r.shape, autotune.record_launch(r, spec),
                getattr(torch, r.dtype), limits, executor=r.executor,
                known_executors=known)
            x, y = operands(r.kind, m, d1, d2, dtype)
            fn, _ = autotune.run_isolated(r.kind, (x, y), pol, s)
            prof_ms = call_device_ms(lambda: fn(x, y))
            timer_ms = r.measured_us / 1e3
            agree = (prof_ms < AUTOTUNE_PROFILED_MS
                     or abs(timer_ms - prof_ms) <= AUTOTUNE_TIMER_TOL
                     * prof_ms)
            emit({"phase": "autotune", "kind": r.kind,
                  "shape": list(r.shape), "dtype": r.dtype, "splits": s,
                  "chooser_splits": pick, "pick_matches": r.pick_matches,
                  "measured_us": r.measured_us, "model_us": r.model_us,
                  "model_error": r.model_error,
                  "model_pick_measured_us": r.model_pick_measured_us,
                  "timer_device_ms": timer_ms,
                  "profiler_call_device_ms": prof_ms,
                  "executor": r.executor,
                  "violations": [v.to_json() for v in vios], "gpu": gpu})
            check(not vios, f"tuning record {r.key} breaks {vios}")
            check(agree, f"autotune {r.key}: timer {timer_ms} ms against "
                  f"the profiler's {prof_ms} ms")
            cases.append((r, dtype, q, x, y))
            del fn

    # The path: every tuned op under the table, counts zeroed before.
    PATH["name"] = "autotune"
    zero_counts()
    want = {n: 0 for n in counts()}
    errs = []
    for r, dtype, q, x, y in cases:
        with tsmm.policy(tuning_table=table, quant=q), recorded() as log:
            got = op(r.kind, x, y, None)
        torch.cuda.synchronize()
        s = r.params_dict.get("splits", 1)
        ran = [lm.splits for e in log for lm in e.launches
               if lm.kind != "reduce"]
        check(ran == [s], f"tabled {r.key} launched at {ran}, its record "
              f"S = {s}")
        name = r.kind + ("_q8" if q == "int8" else "") \
            + ("_split" if s > 1 else "")
        want[name] += 1
        rows, cols = (r.shape[1], r.shape[2]) if r.kind == "tsmt" \
            else (r.shape[0], r.shape[2])
        want["sum_partials"] += perf_model.reduce_kernel_runs(s, rows, cols)
        depth = r.shape[0] if r.kind == "tsmt" else r.shape[1]
        rtol, atol = TOL[dtype]
        if dtype == torch.float32:
            atol *= max(1.0, (depth / 1024) ** 0.5)
        wanted = plain(r.kind, x, y, q)
        errs.append(normalised_err(got, wanted))
        torch.testing.assert_close(got, wanted, rtol=rtol, atol=atol)
    launched = counts()
    want = expect(**{n: v for n, v in want.items() if n != "quantize"})
    check(launched == want, f"autotune path launches {launched}, "
          f"expected {want}")
    # Without the table every shape resolves and launches at the chooser's
    # S: the paths' routes are unchanged.
    for r, dtype, q, x, y in cases:
        if r.kind == "tsm2l":
            continue
        pick = dict(r.model_pick)["splits"]
        pol = tsmm.GemmPolicy(quant=q)
        got = ops.resolve_params(r.kind, *r.shape, dtype, pol,
                                 device=dev)["splits"]
        with tsmm.policy(pol), tsmm.record_dispatches() as log:
            op(r.kind, x, y, None)
        ran = [lm.splits for e in log for lm in e.launches
               if lm.kind != "reduce"]
        check(got == pick and ran == [pick],
              f"untabled {r.key}: resolved {got}, launched {ran}, the "
              f"chooser's S = {pick}")
    del cases, x, y
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    emit({"phase": "autotune", "line": "summary", "records":
          len(table.records), "pick_matches":
          sum(r.pick_matches for r in table.records),
          "max_normalised_err": max(errs), "launches":
          {n: v for n, v in launched.items() if v}, "wall_s": wall,
          "limit_s": AUTOTUNE_MAX_S, "gpu": gpu})
    check(wall < AUTOTUNE_MAX_S,
          f"the autotune phase took {wall} s, over {AUTOTUNE_MAX_S}")
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.core import perf_model
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import quant as k_quant
    from repro_torch.kernels import reduce as k_reduce
    from repro_torch.kernels import tsm2l as k_tsm2l
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.kernels import tsmt as k_tsmt
    from repro_torch.models import model
    from repro_torch.serve import engine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = card()

    # -- 1. build ----------------------------------------------------------
    # ptxas's report compiles four sources again: beside the build, on a
    # thread of its own (both wait on nvcc processes).
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        report = pool.submit(_build.resource_usage, (
            "tsmt_q8", "tsmt_q8_split", "tsm2l", "tsm2l_q8"))
        secs = _build.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "per_kernel_s": secs, "nvcc": _build.nvcc()})
        resources = report.result()
    # The int8 TSMT bodies fit two blocks of 256 threads an SM (launch
    # bounds cap a thread at 128 registers) only if nothing spills.
    emit({"phase": "resources", "kernels": resources})
    tsmt8 = [r for r in resources if r["source"].startswith("tsmt_q8")]
    check(tsmt8 and all(r["spilled_bytes"] == 0 and "registers" in r
                        for r in tsmt8),
          f"int8 TSMT kernels spill or went unreported: {tsmt8}")
    print(gpu, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "precision",
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul.allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, dtype):
        x = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        return x.to(dtype)

    kernels = {     # the sequential kernels' wrappers: no split resolution
        "tsm2r": (k_tsm2r.tsm2r, ref.tsm2r_ref, torch.matmul, "mm"),
        "tsm2l": (k_tsm2l.tsm2l, ref.tsm2l_ref, torch.matmul, "mm"),
        "tsmt": (k_tsmt.tsmt, ref.tsmt_ref,
                 lambda x, y: torch.matmul(x.t(), y), "mmt"),
    }
    # (m, d1, d2): tsm2r/tsm2l (m, k, n); tsmt (m, a, b). Besides the main
    # path's and the paper's shapes: ragged m, k, n and n = 1, and for
    # tsm2l a k past the resident B tile (B staged chunk by chunk). tsm2r
    # adds ragged tails inside the wgmma body's TMA boxes (1000, 776, 200),
    # the same with k % 8 != 0 (simt) and its narrowest width, n = 24, and
    # the skinny body's widths 1, 3, 4, 8 and 16, and shapes smaller than
    # its TMA box of A (k below a box, m below 128 rows).
    cases = {
        "tsm2r": [(8192, 4096, 256), (4096, 4096, 256), (65024, 4096, 4),
                  (16384, 16384, 16), (1000, 777, 16), (4096, 4096, 8),
                  (4096, 4096, 3), (512, 512, 1), (1000, 776, 200),
                  (1000, 777, 200), (4096, 4096, 24), (100, 8, 3),
                  (64, 24, 16), *RWKV_TSM2R, ZAMBA_TSM2R, ZAMBA_HEADS,
                  *[c for c in MOE_TSM2R if c != (4096, 4096, 8)],
                  VISION_HEADS],
        "tsm2l": [(1 << 20, 16, 16), (10 ** 7, 16, 16), (102400, 4, 4),
                  (10000, 300, 20), (5000, 77, 1), (4097, 3, 5),
                  (1003, 129, 16), (333, 1, 16), (4096, 64, 12),
                  (65024, 4, 4)],
        "tsmt": [(1 << 20, 128, 4), (65536, 256, 256), (65536, 128, 4),
                 (10000, 300, 20), (4099, 100, 1),
                 (1000, 100, 3),        # short m: plans S = 1
                 (65024, 4096, 4), (65024, 4, 4), (1 << 20, 16, 16),
                 RWKV_Q, ZAMBA_Q, ZAMBA_HEADS, HUBERT_CHECK, VISION_HEADS],
    }
    # The shape and dtype each kernel meets on the main path.
    main_case = {"tsm2r": ((8192, 4096, 256), torch.bfloat16),
                 "tsm2l": ((102400, 4, 4), torch.float32),
                 "tsmt": ((65536, 128, 4), torch.float32)}
    # tsm2r on the training path: wk/wv forward of a 4096-token microbatch
    # (bf16) and PowerSGD's P = G Q of embed and lm_head (f32); tsmt at
    # PowerSGD's Q and, with tsm2l, at the TSQR passes of the tsqr and
    # train-tsqr paths (Gram and apply at [65024,4] and [2^20,16]).
    train_cases = {"tsm2r": [((4096, 4096, 256), torch.bfloat16),
                             ((65024, 4096, 4), torch.float32)],
                   "tsmt": [((65024, 4096, 4), torch.float32),
                            ((65024, 4, 4), torch.float32),
                            ((1 << 20, 16, 16), torch.float32)],
                   "tsm2l": [((65024, 4, 4), torch.float32)]}
    # rwkv6-1.6b's paths: the decay LoRA's down projection in prefill
    # (8192 tokens) and training (4096), zamba2's shared-LoRA width
    # (n = 128), and PowerSGD's P and Q of its embed and lm_head.
    rwkv_cases = {"tsm2r": [(RWKV_TSM2R[0], torch.bfloat16),
                            (RWKV_TSM2R[1], torch.bfloat16),
                            (RWKV_TSM2R[2], torch.bfloat16),
                            (RWKV_TSM2R[3], torch.float32)],
                  "tsmt": [(RWKV_Q, torch.float32)]}
    # zamba2-1.2b's paths: the shared LoRAs' down projection in prefill
    # (8192 tokens) and a train microbatch (2048), Q of w_down, and P and
    # Q of embed and lm_head.
    zamba_cases = {"tsm2r": [(RWKV_TSM2R[2], torch.bfloat16),
                             (ZAMBA_TSM2R, torch.bfloat16),
                             (ZAMBA_HEADS, torch.float32)],
                   "tsmt": [(ZAMBA_Q, torch.float32),
                            (ZAMBA_HEADS, torch.float32)]}
    # The MoE paths' router and rope-key shapes (MOE_TSM2R), bf16.
    moe_cases = {"tsm2r": [(c, torch.bfloat16) for c in MOE_TSM2R]}
    # hubert-train's offline ABFT tree check: a w_down leaf's checksum.
    hubert_cases = {"tsmt": [(HUBERT_CHECK, torch.float32)]}
    # vision-train's P and Q of embed and lm_head.
    vision_cases = {"tsm2r": [(VISION_HEADS, torch.float32)],
                    "tsmt": [(VISION_HEADS, torch.float32)]}
    # tsm2l at the paper's shapes (its stream body), timed on the device.
    paper_cases = {"tsm2l": [((1 << 20, 16, 16), torch.float32),
                             ((1 << 20, 16, 16), torch.bfloat16),
                             ((10 ** 7, 16, 16), torch.float32),
                             ((10 ** 7, 16, 16), torch.bfloat16)]}
    measured, at_train, at_paper, at_rwkv, at_zamba, at_moe, bad = (
        {}, {}, {}, {}, {}, {}, [])
    at_hubert, at_vision = {}, {}
    for name, (kern, plain, library, entry) in kernels.items():
        for m, d1, d2 in cases[name]:
            for dtype in (torch.float32, torch.bfloat16):
                if entry == "mm":
                    x, y = uniform((m, d1), dtype), uniform((d1, d2), dtype)
                else:
                    x, y = uniform((m, d1), dtype), uniform((m, d2), dtype)
                got = kern(x, y)
                again = kern(x, y)
                torch.cuda.synchronize()
                want = plain(x, y)
                depth = d1 if entry == "mm" else m
                rtol, atol = TOL[dtype]
                if dtype == torch.float32:
                    atol *= max(1.0, (depth / 1024) ** 0.5)
                err = (got.float() - want.float()).abs()
                same = torch.equal(got, again)
                ok = same and bool(
                    (err <= atol + rtol * want.float().abs()).all())
                b_ms, b_by = bound(x, y, got, 2 * m * d1 * d2)
                rec = {"phase": "kernel", "kernel": name,
                       "shape": [m, d1, d2], "dtype": str(dtype)[6:],
                       "kernel_ms": time_ms(lambda: kern(x, y)),
                       "plain_ms": time_ms(lambda: plain(x, y)),
                       "library_ms": time_ms(lambda: library(x, y)),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "max_err": float(err.max()), "rtol": rtol,
                       "atol": atol, "deterministic": same, "ok": ok,
                       "gpu": gpu}
                if name == "tsmt":
                    rec.update(tsmt_plan_check(x, y, got, dtype))
                    rec["ok"] = ok = ok and rec["bits_vs_split_sum"]
                if name == "tsm2l":
                    rec.update(tsm2l_plan_check(x, y, dtype))
                    rec["ok"] = ok = ok and rec["plan_ok"]
                if name == "tsm2r":
                    rec["body"], rec["grid"] = k_tsm2r.plan(x, y)
                    want_body = ("wgmma" if dtype == torch.bfloat16
                                 and (m, d1, d2) in TSM2R_WGMMA else
                                 "skinny" if (m, d1, d2) in TSM2R_SKINNY
                                 else "simt")
                    rec["ok"] = ok = ok and rec["body"] == want_body
                is_main = main_case[name] == ((m, d1, d2), dtype)
                is_train = ((m, d1, d2), dtype) in train_cases.get(name, ())
                is_paper = ((m, d1, d2), dtype) in paper_cases.get(name, ())
                is_rwkv = ((m, d1, d2), dtype) in rwkv_cases.get(name, ())
                is_zamba = ((m, d1, d2), dtype) in zamba_cases.get(name, ())
                is_moe = ((m, d1, d2), dtype) in moe_cases.get(name, ())
                is_hubert = ((m, d1, d2), dtype) in hubert_cases.get(name,
                                                                     ())
                is_vision = ((m, d1, d2), dtype) in vision_cases.get(name,
                                                                     ())
                if (is_main or is_train or is_paper or is_rwkv or is_zamba
                        or is_moe or is_hubert or is_vision):
                    rec["device_ms"] = device_ms(lambda: kern(x, y), name)
                    rec["call_device_ms"] = call_device_ms(
                        lambda: kern(x, y))
                    rec["library_device_ms"] = call_device_ms(
                        lambda: library(x, y))
                emit(rec)
                if not ok:
                    bad.append(f"{name} {m}x{d1}x{d2} {dtype}")
                if is_main:
                    measured[name] = rec
                if is_train:
                    at_train.setdefault(name, []).append(rec)
                if is_paper:
                    at_paper.setdefault(name, []).append(rec)
                if is_rwkv:
                    at_rwkv.setdefault(name, []).append(rec)
                if is_zamba:
                    at_zamba.setdefault(name, []).append(rec)
                if is_moe:
                    at_moe.setdefault(name, []).append(rec)
                if is_hubert:
                    at_hubert.setdefault(name, []).append(rec)
                if is_vision:
                    at_vision.setdefault(name, []).append(rec)
                del x, y, got, again, want, err
    torch.cuda.empty_cache()
    check(not bad, f"kernel phase mismatch in {bad}")
    # tsm2r's wide bf16 shapes run on the tensor cores, under the f32
    # CUDA-core floor.
    for rec in [measured["tsm2r"], *at_train["tsm2r"]]:
        limit = TSM2R_MAX_MS.get(tuple(rec["shape"]))
        if limit is not None and rec["dtype"] == "bfloat16":
            check(rec["body"] == "wgmma" and rec["device_ms"] < limit,
                  f"tsm2r at {rec['shape']}: body {rec['body']}, "
                  f"{rec['device_ms']} ms on the device (limit {limit})")
    # PowerSGD's P streams A on the skinny body.
    (p_rec,) = [r for r in at_train["tsm2r"] if r["dtype"] == "float32"]
    check(p_rec["body"] == "skinny" and p_rec["device_ms"] <= SKINNY_MAX_MS,
          f"tsm2r's P: body {p_rec['body']}, {p_rec['device_ms']} ms on the "
          f"device (limit {SKINNY_MAX_MS})")
    # A base off the 16-byte grid takes tsm2l's tile body.
    buf = uniform((102400 * 16 + 1,), torch.float32)
    x, y = buf[1:].view(102400, 16), uniform((16, 16), torch.float32)
    rec = {"phase": "kernel", "kernel": "tsm2l", "shape": [102400, 16, 16],
           "dtype": "float32", "a_offset_bytes": 4,
           **tsm2l_plan_check(x, y, torch.float32)}
    got, want = k_tsm2l.tsm2l(x, y), ref.tsm2l_ref(x, y)
    rec["max_err"] = float((got - want).abs().max())
    rec["ok"] = (rec["plan_ok"] and rec["body"] == "tile" and bool(
        ((got - want).abs() <= 1e-4 + 1e-3 * want.abs()).all()))
    emit(rec)
    check(rec["ok"], f"tsm2l on a misaligned A: {rec}")
    del buf, x, y, got, want
    # The stream body at the paper's [10^7,16,16] in f32 beats the tile
    # body in the same run, and a fixed gate.
    tile_ms = tsm2l_sweep(dev, uniform, gpu)
    widening_cost(uniform, gpu)
    (big,) = [r for r in at_paper["tsm2l"]
              if r["shape"][0] == 10 ** 7 and r["dtype"] == "float32"]
    check(big["body"] == "stream" and big["device_ms"] < tile_ms
          and big["device_ms"] <= TSM2L_STREAM_MAX_MS,
          f"tsm2l at {big['shape']}: body {big['body']}, "
          f"{big['device_ms']} ms on the device (tile body {tile_ms}, "
          f"limit {TSM2L_STREAM_MAX_MS})")
    at_abft = abft_kernel_rows(dev, uniform, gpu, kernels)
    tsm2r_probes(dev, uniform, gpu)
    skinny_probes(dev, gpu)
    measured.update(split_kernel_phase(dev, uniform, gpu))
    q8_measured, q8_at_train, q8_at_paper = q8_kernel_phase(dev, uniform,
                                                            gpu)
    measured.update(q8_measured)
    measured["quantize"] = quantize_phase(dev, uniform, gpu)
    at_train.update(q8_at_train)
    at_paper.update(q8_at_paper)
    # The one-launch TSMTs spread one output tile over the card, and do
    # so fast enough to beat one block per tile by far.
    for name in ("tsmt", "tsmt_q8"):
        rec = measured[name]
        check(rec["plan_splits"] > 1 and rec["device_ms"] <= TSMT_MAX_MS,
              f"{name} at {rec['shape']}: S = {rec['plan_splits']}, "
              f"{rec['device_ms']} ms on the device")
    at_zamba["tsm2r_split"] = split_rows(dev, uniform, gpu, ZAMBA_P,
                                         torch.float32, "zamba",
                                         ZAMBA_P_SPLITS)
    at_moe["tsm2r_split"] = split_rows(dev, uniform, gpu, MOE_ROUTERS,
                                       torch.bfloat16, "moe")
    tsmt_sweep(dev, uniform, gpu)
    skinny_sweep(dev, uniform, gpu)
    tsmt_q8_sweep(dev, uniform, gpu)
    reduce_sweep(dev, uniform, gpu)
    bound_class_phase(dev, uniform, gpu)
    threshold_sweep(dev, uniform, gpu)

    # -- 3. dispatch (its own path: counts zeroed before, read after) ------
    counters = {"tsm2r": (k_tsm2r, "launches"),
                "tsm2l": (k_tsm2l, "launches"),
                "tsmt": (k_tsmt, "launches"),
                "tsm2r_split": (k_tsm2r, "split_launches"),
                "tsmt_split": (k_tsmt, "split_launches"),
                "sum_partials": (k_reduce, "launches"),
                "tsm2r_q8": (k_tsm2r, "q8_launches"),
                "tsm2l_q8": (k_tsm2l, "q8_launches"),
                "tsmt_q8": (k_tsmt, "q8_launches"),
                "tsm2r_q8_split": (k_tsm2r, "q8_split_launches"),
                "tsmt_q8_split": (k_tsmt, "q8_split_launches"),
                # not TPU kernels: the int8 ops' quantize pass, and
                # tsm2r_q8's change of B's layout (no main path needs one)
                "quantize": (k_quant, "launches"),
                "tsm2r_q8_transpose": (k_tsm2r, "q8_transpose_launches")}

    def counts():
        return {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def expect(fake_quants=0, **nonzero):
        """Launch counts with ``nonzero`` kernels launched: every int8 op
        quantizes both operands once through the fused pass, and each
        int8 PowerSGD factor (``fake_quants``) once more."""
        want = {n: nonzero.get(n, 0) for n in counters}
        want["quantize"] = (2 * sum(want[n] for n in Q8_KERNELS)
                            + fake_quants)
        return want

    # The dispatch path runs with every resolved launch checked against
    # the contracts before it launches.
    PATH["name"] = "dispatch"
    verified = contextlib.ExitStack()
    verified.enter_context(tsmm.policy(verify_contracts=True))
    zero_counts()
    a, b = uniform((4096, 4096), torch.float32), uniform((4096, 8),
                                                         torch.float32)
    a2, b2 = uniform((102400, 4), torch.float32), uniform((4, 4),
                                                          torch.float32)
    a4 = uniform((8, 512, 4), torch.float32)
    x, y = uniform((65536, 128), torch.float32), uniform((65536, 4),
                                                         torch.float32)
    with tsmm.policy(split="never"), recorded() as log:
        outs = [tsmm.tsmm(a, b), tsmm.tsmm(a2, b2), tsmm.tsmm(a4, b2),
                tsmm.tsmm_t(x, y)]
    torch.cuda.synchronize()
    wants = [ref.tsm2r_ref(a, b), ref.tsm2l_ref(a2, b2),
             ref.tsm2l_ref(a4.reshape(-1, 4), b2).reshape(8, 512, 4),
             ref.tsmt_ref(x, y)]
    kinds = [(e.kind, e.executor) for e in log]
    check(kinds == [("tsm2r", "cuda"), ("tsm2l", "cuda"), ("tsm2l", "cuda"),
                    ("tsmt", "cuda")], f"dispatch routes {kinds}")
    # The sequential tsmt's record shows the grid it runs: its own plan.
    plan_s = k_tsmt._plan(65536, 128, 4, dev, torch.float32)[0]
    tsmt_launch = log[3].launches[0]
    check(plan_s > 1 and tsmt_launch.grid == (1, 1, plan_s)
          and tsmt_launch.splits == 1, f"sequential tsmt launch record "
          f"{tsmt_launch} against the plan's S = {plan_s}")
    # The kernel tolerance, its atol grown by sqrt(depth / 1024) past 1,024
    # terms (tsm2r's 4,096 and tsmt's 65,536), as in the kernel phase.
    for got, want, depth in zip(outs, wants, (4096, 4, 4, 65536)):
        torch.testing.assert_close(
            got, want, rtol=1e-3, atol=1e-4 * max(1.0, (depth / 1024) ** 0.5))
    grown = counts()
    check(grown == expect(tsm2r=1, tsm2l=2, tsmt=1),
          f"dispatch launches {grown}")
    emit({"phase": "dispatch", "routes": kinds, "launches": grown,
          "tsmt_grid": tsmt_launch.grid})
    del a, b, a2, b2, a4, x, y, outs, wants

    # A mixed float32/bfloat16 pair and a float16 pair per kernel kind:
    # widened to f32 for the kernel, the output in the left operand's
    # dtype, against the plain version of the widened pair.
    mixed, before = [], counts()
    for kind, entry, sa, sb in WIDENED_OPS:
        op = tsmm.tsmm if entry == "mm" else tsmm.tsmm_t
        plain = ref.tsmt_ref if entry == "mmt" else ref.tsm2r_ref
        for da, db in ((torch.bfloat16, torch.float32),
                       (torch.float16, torch.float16)):
            x, y = uniform(sa, da), uniform(sb, db)
            with tsmm.policy(split="never"), \
                    recorded() as log:
                got = op(x, y)
            want = plain(x.float(), y.float()).to(da)
            torch.cuda.synchronize()
            rtol, atol = TOL[torch.bfloat16]      # a 2-byte output
            err = float((got.float() - want.float()).abs().max())
            ok = (got.dtype == da and [e.kind for e in log] == [kind]
                  and log[0].executor == "cuda" and bool(
                      ((got.float() - want.float()).abs()
                       <= atol + rtol * want.float().abs()).all()))
            mixed.append({"kind": kind, "dtypes": [str(da)[6:], str(db)[6:]],
                          "out": str(got.dtype)[6:], "max_err": err,
                          "ok": ok})
            del x, y, got, want
    grown = {n: v - before[n] for n, v in counts().items()}
    emit({"phase": "dispatch", "mixed_and_f16": mixed, "launches": grown})
    check(all(r["ok"] for r in mixed), f"mixed/f16 dispatch {mixed}")
    check(grown == expect(tsm2r=2, tsm2l=2, tsmt=2),
          f"mixed/f16 dispatch launches {grown}")

    # Split-K: "auto" splits the paper's TSM2R (128 row tiles) and runs
    # PowerSGD's TSMT (32 output tiles) at the S its chooser resolves (the
    # one-launch tsmt at S = 1, which spreads m itself); a pinned S = 8
    # runs both split kernels; "never" keeps them sequential.
    a, b = uniform((16384, 16384), torch.float32), uniform((16384, 16),
                                                           torch.float32)
    x, y = uniform((65024, 4096), torch.float32), uniform((65024, 4),
                                                          torch.float32)
    q_s = ops.resolve_params("tsmt", 65024, 4096, 4, torch.float32,
                             tsmm.GemmPolicy(), device=dev)["splits"]
    for split in ("auto", 8, "never"):
        before = counts()
        with tsmm.policy(split=split), recorded() as log:
            outs = [tsmm.tsmm(a, b), tsmm.tsmm_t(x, y)]
        torch.cuda.synchronize()
        grown = {n: v - before[n] for n, v in counts().items()}
        resolved = [[(lm.kind, lm.splits) for lm in e.launches] for e in log]
        # the epilogue's launch record: the grid of its plan
        reduce_grids = [lm.grid for e in log for lm in e.launches
                        if lm.kind == "reduce"]
        if split != "never":
            s = resolved[0][0][1]
            qs = q_s if split == "auto" else split
            ok = (grown == expect(tsm2r_split=1, sum_partials=1,
                                  tsmt=int(qs == 1), tsmt_split=int(qs > 1))
                  and s > 1 and resolved[1][0] == ("tsmt", qs)
                  and resolved[0][-1][0] == "reduce"
                  and reduce_grids == [perf_model.reduce_plan(
                      s, 16384, 16, torch.float32,
                      spec=perf_model.device_spec(perf_model.H100,
                                                  dev))[0]])
        else:
            ok = grown == expect(tsm2r=1, tsmt=1)
        emit({"phase": "dispatch", "split": split, "resolved": resolved,
              "q_splits_auto": q_s, "reduce_grids": reduce_grids,
              "launches": grown})
        check(ok, f"split={split} dispatch: {resolved} {grown}")
        for got, ref_out in zip(outs, (ref.tsm2r_ref(a, b),
                                       ref.tsmt_ref(x, y))):
            rtol, atol = TOL[torch.float32]
            torch.testing.assert_close(got, ref_out, rtol=rtol,
                                       atol=atol * 8)   # 16384-65024 terms
    del a, b, x, y, outs
    mirror = {}
    tsm2r_shapes = [(16384, 16384, 16), (8192, 4096, 256), (1000, 777, 17),
                    (4096, 4096, 1), (4096, 65536, 16)]
    tsmt_shapes = [(65024, 4096, 4), (1 << 20, 128, 4), (65536, 256, 256),
                   (10000, 300, 20), (4099, 100, 5)]
    for name, grid_fn, shapes in [
            ("tsm2r_split", perf_model.tsm2r_grid, tsm2r_shapes),
            ("tsmt_split", perf_model.tsmt_grid, tsmt_shapes),
            ("tsm2r_q8_split", perf_model.tsm2r_grid, tsm2r_shapes),
            ("tsmt_q8_split", perf_model.tsmt_grid, tsmt_shapes)]:
        for shape in shapes:
            for splits in (1, 8):
                c_grid = _build.grid(name, *shape, splits)
                mirror[f"{name}{list(shape)}S{splits}"] = c_grid
                check(c_grid == grid_fn(*shape, splits),
                      f"tile mirror {name} {shape}: C {c_grid} vs Python "
                      f"{grid_fn(*shape, splits)}")
    # tsm2r's choice of body and grid: the C query against its Python
    # mirror, over dtypes, widths either side of 16, k % 8 and base
    # addresses 16-byte aligned or not (only the pointers' values matter).
    for m, k, n in [(8192, 4096, 256), (4096, 4096, 256), (65024, 4096, 4),
                    (1000, 776, 200), (1000, 777, 200), (4096, 4096, 24),
                    (4096, 4096, 16), (4096, 4096, 20), (512, 512, 1)]:
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for ptr_a, ptr_b in ((0, 0), (2, 0), (0, 8)):
                c_plan = _build.plan(m, k, n, tag, ptr_a, ptr_b)
                mirror[f"tsm2r_plan{[m, k, n]}{tag}@{ptr_a},{ptr_b}"] = c_plan
                check(c_plan == perf_model.tsm2r_plan(m, k, n, dtype, ptr_a,
                                                      ptr_b),
                      f"tsm2r plan mirror {m, k, n} {tag} {ptr_a, ptr_b}: C "
                      f"{c_plan} vs Python "
                      f"{perf_model.tsm2r_plan(m, k, n, dtype, ptr_a, ptr_b)}")
    # tsm2r_split's: widths, k on and off the 16-byte grid, S, and A's base
    # on the 16-byte grid or not (B's does not matter to either body).
    for m, k, n in [(16384, 16384, 16), (4096, 4000, 16), (65024, 4096, 4),
                    (1000, 777, 16), (1000, 1000, 3), (4096, 4096, 17),
                    (8192, 4096, 256)]:
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for S in (2, 5, 8):
                for ptr_a in (0, 4, 8):
                    c_plan = _build.split_plan(m, k, n, S, ref.split_len(
                        k, S, perf_model.TSM2R_BLOCK_K), tag, ptr_a)
                    py_plan = perf_model.tsm2r_plan(m, k, n, dtype, ptr_a,
                                                    splits=S)
                    mirror[f"tsm2r_split_plan{[m, k, n]}S{S}{tag}@{ptr_a}"] = (
                        c_plan)
                    check(c_plan == py_plan, f"tsm2r_split plan mirror "
                          f"{m, k, n} S={S} {tag} @{ptr_a}: C {c_plan} vs "
                          f"Python {py_plan}")
    # tsm2r_q8's: widths either side of 16, k % 16, and bases of A and of
    # the K-major B on the 16-byte grid or not.
    for m, k, n in [(8192, 4096, 256), (4096, 4096, 256), (65024, 4096, 4),
                    (1000, 784, 200), (1000, 776, 200), (1000, 777, 17),
                    (256, 270000, 32), (4096, 4096, 17), (4096, 4096, 16),
                    (512, 512, 1), (64, 0, 256)]:
        for ptr_a, ptr_b in ((0, 0), (4, 0), (0, 8)):
            c_plan = _build.plan(m, k, n, "int8", ptr_a, ptr_b)
            py_plan = perf_model.tsm2r_plan(m, k, n, torch.int8, ptr_a, ptr_b)
            mirror[f"tsm2r_q8_plan{[m, k, n]}@{ptr_a},{ptr_b}"] = c_plan
            check(c_plan == py_plan, f"tsm2r_q8 plan mirror {m, k, n} "
                  f"{ptr_a, ptr_b}: C {c_plan} vs Python {py_plan}")
    # tsm2r_q8_split's: widths either side of 16, k on and off the 16-byte
    # grid (776, 777), slices mid-box (S = 5 at k = 4000), and A's base.
    for m, k, n in [(4096, 65536, 16), (16384, 16384, 16), (65024, 4096, 4),
                    (4096, 4000, 16), (1000, 1008, 3), (1000, 776, 16),
                    (1000, 777, 17), (4096, 4096, 17), (512, 300000, 4)]:
        for S in (2, 4, 5):
            for ptr_a in (0, 4, 16):
                c_plan = _build.split_plan(m, k, n, S, ref.split_len(
                    k, S, perf_model.TSM2R_BLOCK_K), "int8", ptr_a)
                py_plan = perf_model.tsm2r_plan(m, k, n, torch.int8, ptr_a,
                                                splits=S)
                mirror[f"tsm2r_q8_split_plan{[m, k, n]}S{S}@{ptr_a}"] = (
                    c_plan)
                check(c_plan == py_plan, f"tsm2r_q8_split plan mirror "
                      f"{m, k, n} S={S} @{ptr_a}: C {c_plan} vs Python "
                      f"{py_plan}")
    # tsmt_q8's and tsmt_q8_split's: b either side of the packed widths,
    # a % 16, and bases of X and Y on the 16-byte grid or not; the two
    # libraries must agree with each other and with the mirror.
    for m, a, b in [(65024, 4096, 4), (65536, 128, 4), (300000, 16, 4),
                    (10000, 300, 20), (1000, 100, 3), (4096, 128, 8),
                    (4096, 128, 12), (4096, 64, 16), (4096, 136, 4),
                    (4096, 128, 2), (4096, 128, 6), (4096, 128, 17)]:
        for ptr_x, ptr_y in ((0, 0), (8, 0), (0, 4), (16, 32)):
            py_plan = perf_model.tsmt_q8_plan(m, a, b, ptr_x, ptr_y)
            for split in (False, True):
                c_plan = _build.tsmt_q8_plan(m, a, b, ptr_x, ptr_y, split)
                tag = "tsmt_q8_split_plan" if split else "tsmt_q8_plan"
                mirror[f"{tag}{[m, a, b]}@{ptr_x},{ptr_y}"] = c_plan
                check(c_plan == py_plan, f"{tag} mirror {m, a, b} "
                      f"{ptr_x, ptr_y}: C {c_plan} vs Python {py_plan}")
    emit({"phase": "dispatch", "tile_grids_match_c_query": mirror})
    q8_launched = q8_dispatch(dev, uniform, counts, expect)
    verified.close()
    dispatch_launches = counts()
    base = expect(tsm2r=4, tsm2l=4, tsmt=4 + (q_s == 1), tsm2r_split=2,
                  tsmt_split=1 + (q_s > 1), sum_partials=2)
    check(dispatch_launches == {n: base[n] + q8_launched[n] for n in base},
          f"dispatch path launches {dispatch_launches}")

    # -- 3b. the autotuner at the main paths' shapes (its own path: the
    # tuned ops under the table) ------------------------------------------
    autotune_launches = autotune_phase(dev, gpu, counts, zero_counts, expect)

    # -- 4. serve chatglm3-6b (the serving main path) ----------------------
    PATH["name"] = "serve"
    zero_counts()
    cfg = registry.get_config("chatglm3-6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    per_prefill = 2 * cfg.n_layers
    kv = cfg.n_kv_heads * cfg.resolved_head_dim

    before = k_tsm2r.launches
    with recorded() as log:
        t0 = time.perf_counter()
        out = engine.generate(params, cfg, prompts, NEW, device=dev)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    check(k_tsm2r.launches - before == per_prefill,
          f"tsm2r launches per prefill {k_tsm2r.launches - before}")
    routed = [e for e in log if e.kind == "tsm2r"]
    check(len(routed) == per_prefill and all(
        e.executor == "cuda" and e.shape == (BATCH * PROMPT, cfg.d_model, kv)
        for e in routed), f"prefill tsm2r routes {routed[:2]}")
    decode_events = [e for e in log if e.shape[0] == BATCH]
    check(len(decode_events) == (NEW - 1) * cfg.n_layers * 7 and all(
        e.executor == "torch-dense" for e in decode_events),
        "every decode projection goes to torch-dense")
    check(out.shape == (BATCH, NEW), f"greedy output shape {out.shape}")

    sampler = torch.Generator(device=dev).manual_seed(2)
    sampled = engine.generate(params, cfg, prompts, NEW, generator=sampler,
                              temperature=1.0, device=dev)
    check(sampled.shape == (BATCH, NEW) and bool(
        ((sampled >= 0) & (sampled < cfg.vocab_size)).all()),
        "sampled tokens in vocabulary")

    # Step by step through the serve functions, for times and logits.
    step_logits, prefill_ms, decode_ms = serve_step_by_step(
        params, cfg, prompts, out, dev, per_prefill, counts)
    # The main path ends here; what follows only checks it.
    serve_launches = counts()
    SERVE_REF["glm"] = serve_ref(prompts, out, sampled, step_logits,
                                 prefill_ms, decode_ms)
    check(serve_launches == expect(tsm2r=3 * per_prefill),
          f"serving main path launches {serve_launches}")

    dense_prefill, _ = engine.make_serve_fns(
        cfg, policy=tsmm.GemmPolicy(mode="dense"))
    with recorded() as log:
        dense_logits, _ = dense_prefill(
            params, {"tokens": prompts},
            model.init_cache(cfg, BATCH, PROMPT, device=dev))
    check(all(e.executor == "torch-dense" for e in log), "dense arm routes")
    dense_err = normalised_err(step_logits[0], dense_logits)
    check(dense_err <= LOGIT_TOL, f"kernel vs dense arm error {dense_err}")

    full = torch.cat([prompts, out[:, :-1]], dim=1)
    before = k_tsm2r.launches
    forced, _ = model.forward(params, cfg, {"tokens": full})
    check(k_tsm2r.launches - before == per_prefill, "forward launches")
    forward_err = max(normalised_err(step_logits[i], forced[:, PROMPT - 1 + i])
                      for i in range(NEW))
    check(forward_err <= LOGIT_TOL, f"decode vs forward error {forward_err}")
    greedy_agree = sum(int((torch.argmax(step_logits[i], -1) == out[:, i])
                           .sum()) for i in range(NEW))
    emit({"phase": "serve", "model": cfg.name, "params": n_params,
          "dtype": cfg.dtype, "batch": BATCH, "prompt": PROMPT, "new": NEW,
          "init_s": init_s, "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": BATCH * PROMPT / prefill_ms * 1e3,
          "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": BATCH / decode_ms * 1e3,
          "greedy_request_s": greedy_s,
          "tsm2r_launches_per_prefill": per_prefill,
          "dense_arm_err": dense_err, "decode_vs_forward_err": forward_err,
          "greedy_argmax_agree": f"{greedy_agree}/{BATCH * NEW}",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "gpu": gpu})
    profile_serve(engine, model, params, cfg, prompts, out, dev,
                  {"prefill": prefill_ms, "decode": 2 * decode_ms}, gpu)
    del out, step_logits, dense_logits, forced, full
    torch.cuda.empty_cache()

    # -- 4b. abft, serve arm (its own path) ---------------------------------
    PATH["name"] = "abft_serve"
    abft_serve_launches, serve_margin = abft_serve_arm(
        dev, gpu, cfg, params, prompts, counts, zero_counts)
    del params, prompts
    torch.cuda.empty_cache()

    # -- 5. serve chatglm3-6b from int8 records (the serve-int8 path) ------
    PATH["name"] = "serve_int8"
    serve8_launches = serve_int8_phase(dev, gpu, counts, zero_counts, expect)

    # -- 6. grad -----------------------------------------------------------
    PATH["name"] = "grad"
    grad_phase(dev, uniform, gpu)

    # -- 7. train chatglm3-6b (the training main path) ---------------------
    PATH["name"] = "train"
    train_launches, (abft_train_launches, train_margins) = train_phase(
        dev, gpu, counts, zero_counts)
    # The guard's margins on real operands: no clean call may be detected.
    margins = [serve_margin, *train_margins]
    emit({"phase": "abft_margin", "tol_factor": 16.0, "shapes": margins,
          "gpu": gpu})
    check(all(m["clean_detections"] == 0 for m in margins),
          f"the ABFT guard detects a clean call: {margins}")
    check(abft_train_launches["tsm2r"] > 0 and abft_serve_launches["tsm2r"]
          > 0 and abft_train_launches["tsmt"]
          + abft_train_launches["tsmt_split"] > 0,
          f"abft paths: {abft_serve_launches} {abft_train_launches}")
    check(train_launches["tsm2r"] > 0
          and train_launches["tsmt"] + train_launches["tsmt_split"] > 0,
          f"tsm2r or a TSMT kernel was not launched on the training main "
          f"path: {train_launches}")

    # -- 7c. the roofline of the serve prefill and the train step ----------
    roofline_phase(gpu)

    # -- 8. train chatglm3-6b under int8 (the train-int8 path) -------------
    PATH["name"] = "train_int8"
    train8_launches, _ = train_phase(dev, gpu, counts, zero_counts,
                                     quant=True)
    check(train8_launches["tsm2r_q8"] > 0
          and train8_launches["tsmt_q8"] + train8_launches["tsmt_q8_split"]
          > 0, f"tsm2r_q8 or an int8 TSMT kernel was not launched on the "
          f"train-int8 main path: {train8_launches}")

    # -- 9. the tall-skinny QR, and training with PowerSGD on it -----------
    PATH["name"] = "tsqr"
    tsqr_launches = tsqr_phase(dev, gpu, counts, zero_counts)
    PATH["name"] = "train_tsqr"
    train_tsqr_launches = train_tsqr_phase(dev, gpu, counts, zero_counts)
    check(train_tsqr_launches["tsm2l"] > 0,
          "tsm2l was not launched on the train-tsqr path")

    # -- 10. the fault-tolerant launcher (the launch path) ----------------
    PATH["name"] = "launch"
    launch_launches = launch_phase(gpu, counts, zero_counts)

    # -- 10g. the launcher's --distributed in a world of one (the mesh
    # path's launch runs), right after the launch phase whose losses they
    # are held against: at the end of the script a checkpoint read ran
    # at a third of the launch phase's rate (PERF.md section 7) ----------
    PATH["name"] = "mesh"
    t0 = time.perf_counter()
    mesh_launch_launches = mesh_launch(gpu, counts, zero_counts)
    MESH_WALL["launch"] = time.perf_counter() - t0

    # -- 10b-e. rwkv6-1.6b and zamba2-1.2b served and trained at full
    # width and depth (rwkv-serve, rwkv-train, zamba-serve, zamba-train) --
    model_launches = {}
    for mp in (RWKV_PATH, ZAMBA_PATH):
        PATH["name"] = f"{mp.tag}_serve"
        model_launches[PATH["name"]], params, _ = model_serve_phase(
            mp, dev, gpu, counts, zero_counts, expect)
        del params
        torch.cuda.empty_cache()
        PATH["name"] = f"{mp.tag}_train"
        model_launches[PATH["name"]] = model_train_phase(
            mp, dev, gpu, counts, zero_counts, expect)
    check(model_launches["zamba_train"]["tsm2r_split"] > 0,
          "tsm2r_split not on zamba-train")

    # -- 10h. mixtral-8x7b and deepseek-v3-671b at published width
    # (mixtral-serve, mixtral-long, mixtral-train, deepseek-serve) --------
    register_cuts(MOE_CUTS)
    moe_wall = {}
    t0 = time.perf_counter()
    PATH["name"] = "mixtral_serve"
    model_launches["mixtral_serve"], mixtral, mixtral_cfg = (
        model_serve_phase(MIXTRAL_PATH, dev, gpu, counts, zero_counts,
                          expect, keep=True))
    moe_wall["mixtral_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    PATH["name"] = "mixtral_long"
    model_launches["mixtral_long"] = mixtral_long_phase(
        mixtral, mixtral_cfg, dev, gpu, counts, zero_counts, expect)
    del mixtral
    torch.cuda.empty_cache()
    moe_wall["mixtral_long"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    PATH["name"] = "mixtral_train"
    model_launches["mixtral_train"] = model_train_phase(
        MIXTRAL_TRAIN_PATH, dev, gpu, counts, zero_counts, expect)
    moe_wall["mixtral_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    PATH["name"] = "deepseek_serve"
    model_launches["deepseek_serve"], deepseek, _ = model_serve_phase(
        DEEPSEEK_PATH, dev, gpu, counts, zero_counts, expect, keep=True)
    del deepseek
    torch.cuda.empty_cache()
    moe_wall["deepseek_serve"] = time.perf_counter() - t0
    emit({"phase": "moe", "line": "summary", "wall_s": moe_wall,
          "total_s": sum(moe_wall.values()), "gpu": gpu})

    # -- 10i. hubert-xlarge at published width and depth (hubert-serve,
    # hubert-train: the tree check's tsmt) ---------------------------------
    PATH["name"] = "hubert_serve"
    model_launches["hubert_serve"] = hubert_serve_phase(
        HUBERT_PATH, dev, gpu, counts, zero_counts, expect)
    PATH["name"] = "hubert_train"
    model_launches["hubert_train"] = hubert_train_phase(
        dev, gpu, counts, zero_counts, expect)
    check(model_launches["hubert_train"]["tsmt"] > 0,
          "tsmt not on hubert-train")

    # -- 10j. llama-3.2-vision-11b at published width: vision-serve (40
    # layers, no kernel), vision-train (one group: P on tsm2r, Q on tsmt
    # at [128256,4096]) ----------------------------------------------------
    register_cuts(VISION_CUTS)
    PATH["name"] = "vision_serve"
    model_launches["vision_serve"], params, _ = model_serve_phase(
        VISION_PATH, dev, gpu, counts, zero_counts, expect)
    del params
    torch.cuda.empty_cache()
    PATH["name"] = "vision_train"
    model_launches["vision_train"] = model_train_phase(
        VISION_CUT_PATH, dev, gpu, counts, zero_counts, expect)

    # -- 10f. the shard_map executors and sharded PowerSGD (the dist path)
    PATH["name"] = "dist"
    dist_launches_, mesh_launches, mesh_model_launches = dist_phase(
        dev, gpu, counts, zero_counts, expect)

    add_launches(mesh_launches, mesh_launch_launches)
    emit({"phase": "mesh", "line": "summary", "wall_s": MESH_WALL,
          "total_s": sum(MESH_WALL.values()),
          "launches": {n: v for n, v in mesh_launches.items() if v},
          "gpu": gpu})
    check(sum(MESH_WALL.values()) < MESH_MAX_S,
          f"the mesh phase took {MESH_WALL} s, over {MESH_MAX_S}")

    # -- 11. every recorded launch against the contracts -------------------
    contracts_phase(dev, gpu)

    # -- 12. kernels line --------------------------------------------------
    replaces = {"tsm2r": "src/repro/kernels/tsm2r.py:62",
                "tsm2l": "src/repro/kernels/tsm2l.py:48",
                "tsmt": "src/repro/kernels/tsmt.py:63",
                "tsm2r_split": "src/repro/kernels/tsm2r.py:112",
                "tsmt_split": "src/repro/kernels/tsmt.py:115",
                "sum_partials": "src/repro/kernels/reduce.py:45",
                "tsm2r_q8": "src/repro/kernels/quant.py:192",
                "tsm2r_q8_split": "src/repro/kernels/quant.py:254",
                "tsm2l_q8": "src/repro/kernels/quant.py:318",
                "tsmt_q8": "src/repro/kernels/quant.py:387",
                "tsmt_q8_split": "src/repro/kernels/quant.py:448"}
    paths = {"dispatch": dispatch_launches,
             "autotune": autotune_launches, "serve": serve_launches,
             "train": train_launches, "serve_int8": serve8_launches,
             "train_int8": train8_launches, "tsqr": tsqr_launches,
             "train_tsqr": train_tsqr_launches,
             "abft_serve": abft_serve_launches,
             "abft_train": abft_train_launches, "launch": launch_launches,
             **model_launches, "dist": dist_launches_,
             "mesh": mesh_launches, **mesh_model_launches}
    # The quantize pass is not a TPU kernel: it replaces the jnp helpers
    # quantize_blocks (:56) and quantize_tensor (:83), no pallas_call.
    replaces["quantize"] = "src/repro/kernels/quant.py:56"
    sources = {"sum_partials": "reduce"}
    line = []
    for name in [*KERNEL_NAMES, "quantize"]:
        rec = measured[name]
        check(dispatch_launches[name] > 0,
              f"{name} was not launched on the dispatch path")
        line.append({
            "name": name, "route": "cuda",
            "tpu_kernel": name != "quantize",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{sources.get(name, name)}.cu",
            "replaces": replaces[name],
            "launches": sum(c[name] for c in paths.values()),
            **{f"launches_{p}": c[name] for p, c in paths.items()},
            "max_abs_err": rec["max_err"], "ms": rec["kernel_ms"],
            "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_dq_ms": rec.get("library_dq_ms"),
            "library_device_ms": rec["library_device_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"],
            "splits": rec.get("plan_splits", rec.get("splits", 1)),
            **({"body": rec["body"]} if "body" in rec else {}),
            "at_train_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"],
                **({"body": r["body"]} if "body" in r else {}),
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_dq_ms": r.get("library_dq_ms"),
                "library_device_ms": r["library_device_ms"]}
                for r in at_train.get(name, ())],
            **({"at_paper_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"], "body": r["body"],
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_dq_ms": r.get("library_dq_ms"),
                "library_device_ms": r["library_device_ms"]}
                for r in at_paper[name]]} if name in at_paper else {}),
            **({"at_abft_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"],
                "stages": r["stages"], "dispatch_splits": r["dispatch_splits"],
                "dispatch_device_ms": r["dispatch_device_ms"],
                **({k: r[k] for k in ("split_kernel", "split_max_err",
                                      "dispatch_max_err", "split_ms",
                                      "split_device_ms")}
                   if "split_device_ms" in r else {}),
                **({"body": r["body"]} if "body" in r else {}),
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_device_ms": r["library_device_ms"]}
                for r in at_abft[name]]} if name in at_abft else {}),
            **({"at_rwkv_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"],
                **({"body": r["body"]} if "body" in r else {}),
                **({"splits": r["plan_splits"]} if "plan_splits" in r
                   else {}),
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_device_ms": r["library_device_ms"]}
                for r in at_rwkv[name]]} if name in at_rwkv else {}),
            **({"at_zamba_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"],
                **({"body": r["body"]} if "body" in r else {}),
                **({k: r[k] for k in ("plan_splits", "splits", "op_ms",
                                      "seq_ms", "seq_device_ms") if k in r}),
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_device_ms": r["library_device_ms"]}
                for r in at_zamba[name]]} if name in at_zamba else {}),
            **({"at_moe_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"],
                **({"body": r["body"]} if "body" in r else {}),
                **({k: r[k] for k in ("splits", "op_ms", "seq_ms",
                                      "seq_device_ms") if k in r}),
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_device_ms": r["library_device_ms"]}
                for r in at_moe[name]]} if name in at_moe else {}),
            **({"at_hubert_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"],
                **({"splits": r["plan_splits"]} if "plan_splits" in r
                   else {}),
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_device_ms": r["library_device_ms"]}
                for r in at_hubert[name]]} if name in at_hubert else {}),
            **({"at_vision_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"],
                **({"body": r["body"]} if "body" in r else {}),
                **({"splits": r["plan_splits"]} if "plan_splits" in r
                   else {}),
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"],
                "call_device_ms": r["call_device_ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_device_ms": r["library_device_ms"]}
                for r in at_vision[name]]} if name in at_vision else {})})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
