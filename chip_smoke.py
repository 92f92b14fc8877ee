#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`pbf_sph_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each printing one line or more; the first failed check ends the run
with a non-zero exit and no result line:

1. the card (`nvidia-smi` name and power limit), torch, CUDA and nvcc;
2. build the CUDA kernels from `pbf_sph_tpu_torch/csrc` (nvcc, at first use);
3. each phase kernel of `csrc/pbf_phases.cu` against its plain PyTorch
   version on the card, on the sort-time state of dam_break(32_000, 3) and
   dam_break(1_000_000, 6): diffuse count exact and colour sums to atol
   1e-6, lambda to atol 1e-6 / rtol 1e-5, pStar after one delta phase to
   atol 1e-5 (simulation units); with CUDA-event times of both.  The
   per-row lambda and delta are off the main path (which runs
   `csrc/pbf_cells.cu`): one round through their `PbfPhases` wrappers on
   each state counts their launches;
3b. row 4's MC field kernel (`mc_field`, off the main path since row 4b)
   against its plain version on the card, on the post-finalise state of
   mc128k (res 1.0) and bench20k (res 2.0): count exact, S0 and S to rtol
   1e-4 / atol 1e-3, the post-passed v, n and c as `tests/test_pallas_mc.py`
   holds them, the skip node 0; with CUDA-event times and node-candidate
   pairs per second, and its launches in this phase (`ROW4_LAUNCHES`);
3c. the tiled kernels (`csrc/pbf_tiles.cu`, the Pallas sub/mxu variants),
   for every instantiated sub (8, 16, 32, 64) and both r2 routes, on the
   same two states: the cull kernels through their `PbfPhases(h, sub, mxu)`
   wrappers and the dense ones through `DenseTiles`; the cull kernels bit
   for bit the dense ones on every member row; each against its tile plain
   version (the cull kernels' masked by `tile_keep_plain`): lambda atol
   1e-6 / rtol 1e-5, pStar after one delta phase and the clamp atol 1e-5;
   with CUDA-event times, the kept pairs (counted by `tile_keep_plain` on
   the card), tile pairs, per-row pairs and the bound.  No solver path runs
   these kernels, so their launches are counted over this phase;
3d. the v2 compacted-candidate kernels (`csrc/pbf_phases2.cu`) on the same
   two states: the chain once through its `PbfPhases2` wrappers (λ2, Δp2
   and diffuse2 on the cull kernels), with the plan grown until it has no
   overflow, and the dense λ2, Δp2 and diffuse2 once through
   `DensePhases2`; then each kernel against its plain version: the
   compaction of the pStar and lambda packs bit for bit on every column
   below nchunkp*128, lambda2 atol 1e-6 / rtol 1e-5, pStar after delta2 and
   the clamp atol 1e-5, diffuse2 count exact and sums atol 1e-6; the cull
   λ2, Δp2 and diffuse2 bit for bit the dense
   ones on every member row and to the same tolerances of the plain
   versions there (diffuse2's also of the plain version masked by
   `diffuse_keep_plain`, on every row); with CUDA-event times, slab pairs
   and kept pairs (counted by the plain mirrors of the cull,
   `cull_keep_plain` and `diffuse_keep_plain`, on the card) per second, the
   bound (for the dense three and the cull three, over the per-row pairs of
   the phase whose result they give), the slab roofline (the cull diffuse2:
   its kept read, [w, bcl] and the kept slots' colours) and, for the
   compaction, the time of `index_select` over the plan's column map.  No
   solver path runs these kernels either: their launches are counted over
   this phase;
3e. the rate-anchor kernels (`csrc/anchor_rate.cu`, the kernels of
   `tools/anchor_rate.py`): the SASS of each (cuobjdump: every issue
   instantiation's loop holds nstreams*unroll instructions of its op, the
   body loop one MUFU.RSQ and one LDS.128 a pair and the fp32 instructions a
   pair of pbf_lambda's / pbf_delta's own loop, the blocked body's loop
   BLOCKED_ROWS MUFU.RSQ a LDS.128, the fp32 instructions a pair of
   pbf_lambda_cells' / pbf_delta_cells' loop and no local memory, the row
   kernel pbf_lambda's 32-bit loads and pair loop), each against its plain
   version (every issue instantiation and the λ/Δp bodies rtol 1e-5 / atol
   1e-6, the blocked bodies the same on seeds 0-1 at strides 1-2 and rtol
   n eps = 4.88e-4 on the tool's inputs, whose 4096 like terms a row drift
   one way in a running fp32 sum, and on each bit for bit the body kernel,
   the row kernel atol 1e-9), then one rate reading of each through the
   `Anchor` wrappers at the tool's sizes (CUDA events, the marginal between
   two sizes, the SM clock sampled), and the blocked λ body at 7b's work
   (the same threads, iterations / BLOCKED_ROWS) for its line; its launches
   are counted over this phase, and its wall time printed;
3f. the window micro-benchmark kernels (`csrc/micro_window.cu`, the kernels
   of `tools/micro_window.py`): the SASS of each body at W 128 and W 1
   (cuobjdump: one MUFU.RSQ a pair, pbf_lambda's fp32 instructions a pair
   opcode by opcode, 12 bytes of candidate loads a pair split and 16 fused,
   4 more for the flat list at W 1; the JAX tool's five bodies and prod and
   guarded with fused loads; the blocked prod, guarded and flat, split and
   fused, and the blocked static: BLOCKED_ROWS MUFU.RSQ a LDS.128, no global
   load in the pair loop, the same fp32 instructions a pair, no local
   memory), each body against its plain version at both widths on the
   tool's inputs and random ones (the blocked ones also on long windows,
   flat lists and static offsets of several stage rounds, an empty flat
   list and, at W 1, on every window empty; rtol 5e-4, atol 1e-12), each
   blocked kernel bit for bit its original on every block of nblocks 3 on
   all those cases, then one scenario-A reading of each through
   `MicroWindow` (CUDA events, the marginal between nblocks 256 and 1024,
   the SM clock sampled); its launches are counted over this phase, and its
   wall time printed;
3g. the MC-field bisection kernels (`mc_field_noop`, `mc_field_rows`,
   `mc_field_loops` of `csrc/mc_field.cu`, the variants of
   `tools/micro_mc_field.py`): the SASS (cuobjdump: noop and rows without a
   loop, loops one 16-byte load and one FFMA a candidate and no MUFU,
   mc_field's candidate loops the opcodes of the kernel before the
   bisection bodies), each against its plain version on 3b's two finalised
   states (noop zero, rows bit for bit, loops rtol 1e-5 with atol 1e-6 x
   max|value|), then one kernel-ladder reading at mc128k through
   `McFieldBisect` (noop -> rows -> loops -> full, CUDA events over
   back-to-back launches and over a CUDA graph of captured launches, the SM
   clock sampled), then noop, its redesign `mc_field_zero_fill` (the same
   zeros by 16-byte stores over the filled card, held equal to noop's plain
   version at both states, into a NaN-filled output) and `torch.zeros((9,
   L))`, the call that computes what both write, read in 10 turns of a CUDA
   graph of 100 launches each (medians, min-max and whether each kernel
   loses to the call); its launches are counted over this phase;
3n. the main path's MC field (`mc_field_cells` of `csrc/mc_field_cells.cu`,
   row 4b: row 4's sums over the z-clamped ranges with the post-pass
   folded in) on 3b's two finalised states, against its plain version and
   against row 4 (`post_pass(mc_field(...))`): v to rtol 1e-4 / atol 1e-3,
   n and c as 3b holds them, the NaN pattern of c element for element, the
   skip node 0 in all 8 rows (`micro_mc_field.cells_agree`), and two
   launches bit for bit; then at each state the kernel alone beside row 4's
   kernel, and `McField.__call__` (one allocation, one launch) beside row
   4's call rebuilt from its pieces (`field_by_pieces`), in 5 turns of a CUDA
   graph of 100 launches (`micro_mc_field.cells_turns`), the host ms a call
   of both calls, G node-candidate pairs/s and the bound;
3h. the pair-chunk and loop probes (`csrc/micro_chunk.cu`, the kernels of
   `tools/micro_chunk.py`; `csrc/micro_loop.cu`, the bodies that
   `tools/micro_loop.py` runs): the SASS (cuobjdump: each pair body's trip
   loop `interleave` pairs and the fp32 instructions a pair-slot of
   interleave 1, no branch in the new body and only the two slow-path
   guards in the old; each loop one trip of its ops: a) one FFMA and the
   loop's own instructions, b)-d) k FFMAs, e) eight of its op), each kernel
   against its plain version at fewer trips on the tools' inputs and seeded
   ones (chunk sums rtol 1e-5 / atol 1e-9, the fma ceiling rtol 1e-6, the
   loop bodies exact but rsqrt rtol 1e-6), then one reading of each kernel
   with the card filled through `MicroChunk` / `MicroLoop` (CUDA events, the
   marginal between two trip counts, the SM clock sampled); its launches are
   counted over this phase;
3i. the dense-λ micro-benchmark (`csrc/micro_dense.cu`, the kernels of
   `tools/micro_dense.py`): the SASS (cuobjdump: `pbf_lambda`'s fp32
   instructions a pair, opcode by opcode, and one MUFU.RSQ a pair-slot in
   a, b, c, e, f, h, i, j and k, each loop its pairs a trip, b)'s bound an
   immediate, l)'s sqrt and divide with their slow-path guards, d)/g) 8/32
   DMMAs a chunk a warp, k)'s bulk copy and barrier wait), each of the
   twelve bodies against its plain version over 2 copies on the tool's
   inputs and on seeded ones with fewer chunks (rtol 1e-5, atol 1e-5 x
   max|value|), d) and g) also inside the range a float64 evaluation of
   the TPU tool's r2 takes under the rounding of its fp32 operands and
   sums (`mxu_f64`), then one
   reading of each kernel through `MicroDense` at the JAX call's size (64
   copies, CUDA events, the marginal over 16 and 64 copies, the SM clock
   sampled), its bound from the work the function needs (PAIR_WORK); its
   launches are counted over this phase;
3j. the compaction building blocks (`csrc/micro_roll.cu`, the kernels of
   `tools/micro_roll.py` and the roll, unaligned-slice and unaligned-copy
   probes of `tools/micro_vpu.py`): the SASS (cuobjdump: a)/b) 32 SHFL a
   trip, 4 a roll, vpu_rot 32; each part body's loop its parts' float4
   stores, shuffle 16 SHFL a part, direct 16 32-bit loads; each blocked
   part body's loop no store, shuffle 4 SHFL and 8 32-bit loads a visit,
   direct 4 32-bit loads; f) 16 pairs a pass with `pbf_lambda`'s fp32
   instructions a pair beside its reduction; vpu_unal 32-bit loads,
   vpu_dma 4 cp.async copies and a barrier wait; no local memory), each
   kernel against its plain version on the tools' inputs and seeded ones
   (bit for bit, NaN in place, for a)-e), the blocked c)-e) also against
   the original's bits, and the probes, at every seeded shift and offset;
   f) rtol 1e-5, atol 1e-5 x max|value|), then one reading of each kernel
   through `MicroRoll` (CUDA events, the marginal between two trip or pass
   counts, the probes in a CUDA graph of 100 launches, the SM clock
   sampled), each part body reading's output at 512 copies then held bit
   for bit against `part_plain`; its launches are counted over this phase;
3k. the op streams, dots and reshape (`csrc/micro_vpu.cu`, the rest of
   `tools/micro_vpu.py`: bench_streams, dot_kernel, dot2_kernel, tr_kernel,
   and the redesigns of dot_kernel, tr_kernel and dot2_kernel,
   `vpu_dot_spread`, `vpu_tr_split` and `vpu_dot2_spread`): the SASS
   (cuobjdump: each stream's trip loop one op a carry, sqrt and div with
   one slow-path guard a carry on their fast path; each dot's trip loop
   its products, scale multiplies, one add an output and its shared-memory
   reads; tr one FFMA a trip, restage with its store, barrier and load
   inside the trip; dot_spread's tile loop its products, scale multiplies,
   b's reads and stores and its chain one FADD a trip; dot2_spread's tile
   loop its products, the row's scale multiplies and float4 stores, no
   shared-memory read and no multiply of a product, its chain one FADD a
   trip and a float4 read every 4, no tensor-core instruction; tr_split's
   chain unrolled, an FFMA and its scale a trip, its tree by shuffles and
   no atomics; no local memory), each kernel against its plain version at
   256 trips on the tool's inputs and seeded ones, every CTA of the
   streams' card-filling grid and of two copies of the dots and tr, and
   the redesigns also on seeded inputs at more trips (dot_spread 2245 and
   8192, tr_split 250 and 8192 over 64 parts, 256 over 1 and 256 parts;
   dot2_spread on both inputs at 256, 2245 and 8192 over 3 copies; bit
   for bit, but rsqrt rtol 1e-6), then one reading of each through
   `MicroVpu` (CUDA events, the marginal between 2048 and 8192 trips, the SM
   clock sampled; the redesigns at 8192 trips in a CUDA graph of 100
   launches, CUDA events beside, and tr_split at 0 trips, the launch with
   no trip) and the library call of the dots (`torch.matmul`) and of tr
   (`torch.mv`) in a CUDA graph; its launches are counted over this phase;
3l. the main path's λ/Δp kernels (`csrc/pbf_cells.cu`, `pbf_lambda_cells` and
   `pbf_delta_cells` on their (C, 4) packs, the direct walk) and their
   staged walk (`csrc/cells_staged.cu`, `tools/cells_staged.py`), off the
   main path: the SASS (cuobjdump: each pair loop the per-row
   kernel's fp32 instructions a pair without rsqrtf's denormal guard, λ 18
   and Δp 26, one MUFU.RSQ and one float4 read a pair, LDG.128 direct and
   LDS.128 staged, none of the other kind in the loop, no local memory),
   each against its plain version on the sort-time states of
   dam_break(32_000, 3) and dam_break(1_000_000, 6) and an over-compressed
   2-cube state whose unions exceed the stage of shared memory (λ atol 1e-6
   / rtol 1e-5, pStar after one delta and the clamp atol 1e-5, B's xyz A's
   and A's mass kept), the largest difference from the per-row kernels with
   the wrappers' mask and clamp printed, one round of the staged walk
   through `cells_staged.StagedCells` on each state (its launches are
   counted here), then at the 1M state the device time of each
   (`anchor_rate.held_ms`) beside its plain version's, its bound and the
   anchored ms (the per-row pairs over the blocked anchor bodies' ceilings,
   `bench_cells.CELLS_CEILING`);
3m. the main path's diffuse kernels (`csrc/pbf_diffuse_cells.cu`,
   `pbf_diffuse_cell_sums` and `pbf_diffuse_cells`) against their plain
   versions bit for bit on the sort-time states of dam_break(32_000, 3),
   dam_break(1_000_000, 6) and the 32k state with seeded colours and a
   seeded 10% of its rows OBSTACLE and 5% dead; the 27-cell count exact
   against the per-row `pbf_diffuse`'s, the 27-cell colour sums within an
   fp32 sum's bound ((2 count + 27) 2^-24 of the sum) of its sums and the
   colour within atol 1e-6 of row 3's path; then at
   the 1M state the device time of each (`held_ms`) beside its plain
   version's, its bound (the bytes in and out over 3.35 TB/s, the pack's 5
   floats a cell that hold sums, not its 3 pad floats) and, for the
   cell sums, `index_add_`'s, and the wrapper's time beside row 3's path;
4. TorchSolver on the card against TorchSolver on the CPU, 2 frames of
   simple_config_with_2_cubes(700, 2, 500): position and velocity to atol
   1e-3, colour to 1e-5;
4b. mc_extract on the card against mc_extract on the CPU on the mc128k
   lattice of 3b: triangle count exact, vertices, normals and colours to atol
   1e-4 (NaN where the CPU has NaN); then one advance of
   simple_config_with_2_cubes(1500, 2, 500) with its surface on the card and
   on the CPU: triangle counts within 1%;
5. the main path: dam_break(1_000_000, solver_iter=6) through
   TorchSolver(device="cuda"): prepare, the growth warmup of the benchmark,
   then timed frames; particles conserved, grid extent held, no capacity
   overflow, positions finite and inside the bounds, and exactly 14 kernel
   launches per frame (1 diffuse_cell_sums + 1 diffuse_cells + 6
   lambda_cells + 6 delta_cells); with the stage times;
6. the surface path: mc128k, dam_break(128_000, 3) with its marching-cubes
   surface, through TorchSolver(device="cuda") in the same way: particles
   conserved, extent held, no growth pending, no emit overflow,
   0 < tri_count <= tri_capacity, the mesh's vertices finite and within
   h*scale of the bounds, and exactly 9 kernel launches per frame
   (1 mc_field_cells + 1 + 1 diffuse + 3 lambda_cells + 3 delta_cells); row
   4's mc_field, counted by its launcher, 0 on both paths; with the stage
   times;
7. the gather backend (`TorchSolver(gather=True)`: the JAX package's XLA
   gather path on plain torch ops, no kernel) and the CLI:
7a. gather on the card against gather on the CPU, 2 frames of
   simple_config_with_2_cubes(700, 2, 500) with its surface: in float32
   phase 4's tolerances, in float64 position, velocity and colour atol
   1e-7; triangle counts within 1%;
7b. gather against the kernel backend on the card, one frame of mc128k from
   the same particles: particle count exact, position and velocity atol
   1e-3, colour 1e-5, triangle counts within 1%;
7c. dam1m through gather in float32: prepare, the growth warmup (2 frames a
   round), then 3 timed frames; phase 5's checks, 0 launches of every port
   kernel; ms/step, the peak device memory and one frame's stage times;
7d. mc128k through gather in float64 with its surface, in the same way:
   phase 6's checks, 0 launches; ms/step and one frame's stage times;
7e. `pbf_sph_tpu_torch.cli.main` on bench20k, `--warmup 2 --iter 3`, once
   with `--impl torch` and once with `--impl gather --fp64`: each returns 0
   and prints the stats block; the final particle count is the input's,
   the vertex count above 0, and both files are written and read back; the
   kernel backend's solver launched kernels, the gather backend's none;
   `--impl torch --fp64` returns 1.  Each backend's frame-time mean is
   printed beside the card line;
8. the visualise loop, `pbf_sph_tpu_torch.visualise.main` in-process with
   `--devices` left at its default, its module-level `make_solver`,
   `save_ply_points`, `save_obj_mesh` and `render_frame` wrapped to keep the
   solver, each frame's launches (the counts set to 0 just before each
   `advance` and read just after) and the host-clock time of `advance` and
   of each file written.  Each card run: rc 0, the solver the kernel
   backend on cuda, the files written exactly the expected set, each PLY
   the particle count, each OBJ > 0 vertices finite and within h*scale of
   its frame's bounds, each PNG 640x480 with covered pixels, and each
   frame's launches a whole number of attempts of its frame's set (9 at
   iteration 3 with the surface, 5 at iteration 1, 2 + 2 iteration without
   it; 0 of the per-row kernels and row 4's `mc_field`);
8a. the GUI workload: the 2-cube scene, `--particles 20000 --solver-iter 3
   --frames 24 --every 4 --render --checkpoint-every 8 --turntable 2`,
   motion on, with `--set`s 6:iteration=1, 10:mc_resolution=1.0,
   14:surface=0, 18:surface=1 (back at `McParams()`'s defaults) and
   20:force=0,12,0, each held to take effect at its frame; then `--resume`
   from its frame-16 checkpoint for 2 frames (17-18, the count conserved),
   and the first 2 frames of a 700-particle copy on the card and with
   `--devices cpu`: phase 4's tolerances, triangle counts within 1%;
8b. the rendering user's loop: `--workload dam --particles 128000
   --solver-iter 3 --mc-resolution 1.0 --frames 12` (mc128k's lattice),
   export every frame, once without `--render` and once with it, 8a's checks
   and every step spec at res 1.0; the host-clock means over frames 2-11 of
   `advance`, the PLY write, the OBJ write and the render, beside the card
   line.  The launches of phase 8's card runs are printed on a line of
   their own; the kernels line keeps the launches of the phases above;
9. the 1D slab engine (`pbf_sph_tpu_torch/parallel/sharded.py`), its ranks
   as threads of this process on cuda:0 (`parallel/comm.py` ThreadComm),
   the kernel backend on every rank, launches counted per rank (set to 0
   just before a run's first frame and read just after its last):
9a. dam_break(20_000, 3), fixed slabs, 2 frames at D=2 and D=4: each
   rank's ghost_peak (some > 0 at D=4), no dropped or deferred particle;
   the busiest D=4 rank's first-frame diffuse, λ and Δp kernels against
   their plain versions on its inputs (3l's and 3m's tolerances); the
   particles against the same runs on the CPU (plain versions; phase 4's
   tolerances) and against TorchSolver(device="cuda") (count exact,
   position and velocity atol 0.1, colour 2e-3); every rank 1
   diffuse_cell_sums + 1 diffuse_cells + 3 lambda_cells + 3 delta_cells a
   frame and 0 of the per-row kernels and row 4; D=2 twice, the same bits;
9b. dam1m at D=4 with rebalance=True, sloshing bounds, 2 warmup and 4
   timed frames: particles conserved, no dropped particle or ghost, no
   deferral at the end, extent held, the bounds moved; ms/frame on the host
   clock beside the card line and phase 5's ms/step (four ranks share the
   one card: not a multi-card speed);
9c. mc128k with its surface at D=2, rebalance=True, 2 frames: triangles
   within 1% of TorchSolver(gather=True) (the same XLA field), the
   gathered mesh 3 rows a triangle, finite and within h*scale of the
   bounds;
9d. `pbf_sph_tpu_torch.cli.main` with `--multichip 1` on bench20k (NCCL at
   world size 1), fixed and `--rebalance`: rc 0, the stats block with
   `Per-device particles`, the particle count the input's, both files
   written and read back; `--multichip 2` on this one card fails with its
   message.  Phase 9's launches are printed on a line of their own;
9e-9h. the 2D tile engine (`pbf_sph_tpu_torch/parallel/sharded2d.py`) the
   same way, its 2x2 ranks (x-major) ThreadComm threads on cuda:0:
9e. dam_break(20_000, 3) at 2x2, fixed cuts, 2 frames: ghost_peak > 0 on
   every tile every frame, no dropped or deferred particle; the busiest
   tile's first-frame diffuse, λ and Δp kernels against their plain
   versions on its inputs (3l's and 3m's tolerances); the particles against
   the same run on the CPU (phase 4's tolerances) and against
   TorchSolver(device="cuda") (9a's); every rank 1 + 1 + 3 + 3 launches a
   frame; two runs, the same bits;
9f. dam1m at 2x2, rebalance=True, sloshing bounds, 2 warmup and 4 timed
   frames from cuts one column and one row past the equal-count ones:
   particles conserved, no dropped particle or ghost, no deferral at the
   end, the cuts moved on both axes; ms/frame on the host clock beside
   phase 5's and 9b's; 2 more frames under torch.profiler (busy share, the
   largest kernels);
9g. mc128k with its surface at 2x2, rebalance=True, 2 frames: triangles
   within 1% of TorchSolver(gather=True), the gathered mesh 3 rows a
   triangle, finite and within h*scale of the bounds;
9h. the CLI with `--multichip 1x1` on bench20k (NCCL at world size 1), fixed
   and `--rebalance`: rc 0, `Per-tile particles`, both files read back;
   `--multichip 2x2` on this one card fails with its message.
10. the blocked emission, the dry run and the study tools:
10a. mc128k's first frame with cube_cap 0, emit_block 1024 and emit_cap 128
   through `TorchSolver.advance`: its first attempt overflows on the card,
   the growth re-runs it, and the mesh equals the one-stage scatter's
   (emit_block 0, cube_cap 0) bit for bit, with the triangle count of the
   production spec (cube compaction); each kernel of the surface path
   launched in the advance, counts set to 0 just before it;
10b. `parallel.dryrun.dryrun_multichip(4)` on the card: 4 ThreadComm ranks,
   the 2-cube scene with a surface, a source, a drain, a well and a query:
   every overflow 0, a mesh, the alive count the gathered one, and each
   rank's kernels launched (counts set to 0 when its step is built);
10c. each new study tool's `main` once at a small size: bench_mc_split
   (bench20k), micro_extract (bench20k, B 1024 and 4096: every emission's
   mesh the production one's), roofline (32k), precision_centered,
   load_balance (32k, 4 slabs, 20 frames, rebalancing) and multichip_model
   (32k; its exchange census equal to the byte model); rc 0 and the last
   line JSON.
11. the host oracles and the last tools:
11a. `TorchSolver(device="cuda")` (the kernel backend) against the port's
   C++/OpenMP oracle (`models/cpp_solver.py`, built with g++ here) from the
   same particles, under `tests/test_jax_vs_oracle.py`'s criteria: one
   frame of simple_config_with_2_cubes(ORACLE_COUNT = 14000, 3, 500),
   the largest whose cubes stay inside the 1000 bound, position and
   velocity atol 0.02, colour 1e-3; its surface frame, triangle counts
   within max(3, 1%) and centroid IoU > 0.95; one frame's SPH densities (a
   NumPy poly6 over a k-d tree's pairs) rtol 2e-3; the
   well/source/drain/query scene at 14000 particles, position and velocity
   0.05 and the query's neighbour set equal; three frames with motion at
   2000, 0.2, 0.5 and 5e-3 (at 14000 printed as a reading beside the
   oracle's fp64 frames, which part from its fp32 ones by more than that).
   One frame of bench20k (simple_config_with_2_cubes(20000, 6, 500)) with
   its surface is printed as a reading beside the oracle's own fp64 frame,
   which is run twice and must repeat bit for bit: the criteria do not hold
   there between the oracle and itself;
11b. the CLI through the oracles on bench20k: `--impl cpp --warmup 1
   --iter 2`, `--impl cpp --fp64 --phase-timings` (its 12 phases) and
   `--impl numpy --count 2000 --iter 1` (each at warmup 1): rc 0, the stats
   block, both files read back; `--impl cpp --multichip 2` returns 1; the
   oracles' frame-time means on the host clock beside the host CPU's model
   and OpenMP's thread count;
11c. the last three tools' mains: analyze_wcap (dam1m), micro_plan
   (dam1m) and analyze_mc_windows (mc128k); rc 0 and the last line JSON.

Then one JSON line of kernels (launches from the main path that runs each:
phase 5 for diffuse (`diffuse_cell_sums`, `diffuse_cells`, whose line holds
3m's held_ms times at the 1M state) and λ/Δp (`lambda_cells`,
`delta_cells`: the direct walk) and for the per-row diffuse and λ/Δp, which
it no longer runs (0; phase 3's round of them stands beside as
`phase_launches`), 3l for the staged walk, whose line holds the held_ms
times at the 1M state as the direct walk's does, phase 6 for the MC field
(`mc_field_cells`, whose ms is 3n's median in a CUDA graph at mc128k; row
4's `mc_field`, read 0 on phases 5 and 6, with 3b's numbers and 3b's launches
as `phase_launches`), 3c for the tiled
kernels, dense and cull, whose line holds sub 64 with the tensor-core r2, 3d for the v2
kernels, whose compaction numbers are the pStar pack's, 3e for the
rate-anchor kernels, whose line holds fma 16x16, the λ body and the row
kernel at the larger of their two sizes and the blocked λ body at the λ
body's work, 3f for the window kernels, whose
line holds scenario A at nblocks 1024, the flat kernel's split body and the
blocked kernels' split bodies (static's fused, its only one), 3g for
the MC-field bisection kernels, whose ms is the CUDA-graph reading at
mc128k, but noop's and zero_fill's ms and library_ms (torch.zeros of the
(9, L) output) are the medians of their turns, 3h for
the probes, whose line holds the larger size with the card filled: the old
and new bodies at interleave 1, the fma ceiling at 8 streams, the loop
bodies b) 16 streams, c) the chain of 16 and e) rsqrt, each bound by its
fp32 and MUFU instructions over the SMs x 128 lanes of issue or its MUFU
ops over the SMs x 16 of the MUFU pipe, whichever is longer, at the sampled
SM clock), 3i for the dense-λ kernels, whose line holds a), d), g) and k)
at 64 copies, bound as 3h's, d)/g) also by their DMMA flops over the FP64
tensor-core peak), 3j for the compaction building blocks, whose line
holds a) with the card filled, d)'s shuffle and direct bodies, original
and blocked, at the JAX call's 512 copies and f) with the card filled, each
at the larger of its two sizes, bound by its SHFLs, its 32-bit loads and
stores, or its fp32 and MUFU issue, and the probes' CUDA-graph readings,
bound by their bytes, beside torch.roll and x[:, o:o+128].contiguous()),
3k for the op streams, dots and reshape, whose line holds fma at 8 streams
with the card filled, bound by its FFMAs over the issue rate, and the dots
and both tr
bodies at one copy, the dots bound by 2MNK + MK + MN flops a trip over the
fp32 peak beside torch.matmul of the stacked scaled operands and its sum in
a CUDA graph, tr by its FFMAs over the issue rate beside torch.mv of x[0,
0:64] broadcast over the trips with the scales in a CUDA graph, and the
kernel's chain of 8192 dependent FFMAs at the anchor's serial latency
printed beside), the card line
again, and as the last line `{"ok": true, "device": {...}}`.  Without a CUDA
device, or outside a checkout of the repo, it fails before printing any
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TIMED_FRAMES = 10
WARMUP = 10

# kernel name -> (kernel source, TPU kernel it replaces)
KERNELS = {
    "diffuse": ("pbf_sph_tpu_torch/csrc/pbf_phases.cu",
                "pbf_sph_tpu/ops/pallas_pbf.py:578"),
    # the main path's diffuse: make_diffuse_call with the wrapper's mix, as
    # per-cell sums and a 27-cell gather
    "diffuse_cell_sums": ("pbf_sph_tpu_torch/csrc/pbf_diffuse_cells.cu",
                          "pbf_sph_tpu/ops/pallas_pbf.py:578"),
    "diffuse_cells": ("pbf_sph_tpu_torch/csrc/pbf_diffuse_cells.cu",
                      "pbf_sph_tpu/ops/pallas_pbf.py:578"),
    "lambda": ("pbf_sph_tpu_torch/csrc/pbf_phases.cu",
               "pbf_sph_tpu/ops/pallas_pbf.py:391"),
    "delta": ("pbf_sph_tpu_torch/csrc/pbf_phases.cu",
              "pbf_sph_tpu/ops/pallas_pbf.py:491"),
    "mc_field": ("pbf_sph_tpu_torch/csrc/mc_field.cu",
                 "pbf_sph_tpu/ops/pallas_mc.py:185"),
    # the main path's MC field: make_mc_field_call with the post-pass, each
    # node's candidates over a lane group (row 4b)
    "mc_field_cells": ("pbf_sph_tpu_torch/csrc/mc_field_cells.cu",
                       "pbf_sph_tpu/ops/pallas_mc.py:185"),
    # the main path's λ and Δp: make_lambda_call and
    # make_delta_call with the wrappers' mask and clamp (the direct walk)
    "lambda_cells": ("pbf_sph_tpu_torch/csrc/pbf_cells.cu",
                     "pbf_sph_tpu/ops/pallas_pbf.py:391"),
    "delta_cells": ("pbf_sph_tpu_torch/csrc/pbf_cells.cu",
                    "pbf_sph_tpu/ops/pallas_pbf.py:491"),
    # the same kernels' staged walk (candidates in shared memory), off the
    # main path (tools/cells_staged.py)
    "lambda_cells_staged": ("pbf_sph_tpu_torch/csrc/cells_staged.cu",
                            "pbf_sph_tpu/ops/pallas_pbf.py:391"),
    "delta_cells_staged": ("pbf_sph_tpu_torch/csrc/cells_staged.cu",
                           "pbf_sph_tpu/ops/pallas_pbf.py:491"),
    # make_lambda_call / make_delta_call with mxu=True (_centred_r2_mxu :351)
    "lambda_tile": ("pbf_sph_tpu_torch/csrc/pbf_tiles.cu",
                    "pbf_sph_tpu/ops/pallas_pbf.py:391"),
    "delta_tile": ("pbf_sph_tpu_torch/csrc/pbf_tiles.cu",
                   "pbf_sph_tpu/ops/pallas_pbf.py:491"),
    # the same redesigned: only the 8 x 8 row-candidate blocks that can
    # contribute (the kernels PbfPhases(h, sub, mxu) launches)
    "lambda_tile_cull": ("pbf_sph_tpu_torch/csrc/pbf_tiles.cu",
                         "pbf_sph_tpu/ops/pallas_pbf.py:391"),
    "delta_tile_cull": ("pbf_sph_tpu_torch/csrc/pbf_tiles.cu",
                        "pbf_sph_tpu/ops/pallas_pbf.py:491"),
    # the v2 compacted-candidate phases (the dense three on _dense_phase :422)
    "compact": ("pbf_sph_tpu_torch/csrc/pbf_phases2.cu", "tools/pallas_pbf2.py:323"),
    "lambda2": ("pbf_sph_tpu_torch/csrc/pbf_phases2.cu", "tools/pallas_pbf2.py:474"),
    "delta2": ("pbf_sph_tpu_torch/csrc/pbf_phases2.cu", "tools/pallas_pbf2.py:547"),
    # lambda2 and delta2 redesigned: only the slab columns that can
    # contribute (the kernels PbfPhases2 launches)
    "lambda2_cull": ("pbf_sph_tpu_torch/csrc/pbf_phases2.cu", "tools/pallas_pbf2.py:474"),
    "delta2_cull": ("pbf_sph_tpu_torch/csrc/pbf_phases2.cu", "tools/pallas_pbf2.py:547"),
    "diffuse2": ("pbf_sph_tpu_torch/csrc/pbf_phases2.cu", "tools/pallas_pbf2.py:612"),
    # diffuse2 redesigned: only the slab slots some member row's band can
    # accept (the kernel PbfPhases2 launches)
    "diffuse2_cull": ("pbf_sph_tpu_torch/csrc/pbf_phases2.cu", "tools/pallas_pbf2.py:612"),
    # the rate anchor of tools/anchor_rate.py: build_issue, build_body, build_subfix
    "anchor_issue": ("pbf_sph_tpu_torch/csrc/anchor_rate.cu", "tools/anchor_rate.py:116"),
    "anchor_body": ("pbf_sph_tpu_torch/csrc/anchor_rate.cu", "tools/anchor_rate.py:204"),
    # build_body redesigned: R rows a thread on one candidate read, with the
    # main path's pair terms
    "anchor_body_blocked": ("pbf_sph_tpu_torch/csrc/anchor_rate.cu",
                            "tools/anchor_rate.py:204"),
    "anchor_rowfix": ("pbf_sph_tpu_torch/csrc/anchor_rate.cu", "tools/anchor_rate.py:288"),
    # the window micro-benchmark of tools/micro_window.py: build_prod_structure,
    # build_guarded, build_flat (split and fused), build_static_fused
    "window_prod": ("pbf_sph_tpu_torch/csrc/micro_window.cu", "tools/micro_window.py:176"),
    "window_guarded": ("pbf_sph_tpu_torch/csrc/micro_window.cu", "tools/micro_window.py:226"),
    "window_flat": ("pbf_sph_tpu_torch/csrc/micro_window.cu", "tools/micro_window.py:290"),
    "window_static": ("pbf_sph_tpu_torch/csrc/micro_window.cu", "tools/micro_window.py:324"),
    # build_prod_structure and build_guarded redesigned: a warp on one
    # sub-block, R rows a thread on one shared-memory read of each candidate
    "window_prod_blocked": ("pbf_sph_tpu_torch/csrc/micro_window.cu",
                            "tools/micro_window.py:176"),
    "window_guarded_blocked": ("pbf_sph_tpu_torch/csrc/micro_window.cu",
                               "tools/micro_window.py:226"),
    # build_flat and build_static_fused redesigned in the same blocked kernel
    "window_flat_blocked": ("pbf_sph_tpu_torch/csrc/micro_window.cu",
                            "tools/micro_window.py:290"),
    "window_static_blocked": ("pbf_sph_tpu_torch/csrc/micro_window.cu",
                              "tools/micro_window.py:324"),
    # the MC-field bisection of tools/micro_mc_field.py: make_variant's noop,
    # rows and loops bodies
    "mc_field_noop": ("pbf_sph_tpu_torch/csrc/mc_field.cu", "tools/micro_mc_field.py:83"),
    # and its redesign, the same zeros by 16-byte stores over the filled card
    "mc_field_zero_fill": ("pbf_sph_tpu_torch/csrc/mc_field.cu", "tools/micro_mc_field.py:83"),
    "mc_field_rows": ("pbf_sph_tpu_torch/csrc/mc_field.cu", "tools/micro_mc_field.py:83"),
    "mc_field_loops": ("pbf_sph_tpu_torch/csrc/mc_field.cu", "tools/micro_mc_field.py:83"),
    # the pair-chunk micro-benchmark of tools/micro_chunk.py: make_bench's
    # two bodies and fma_ceiling; the loop probes that tools/micro_loop.py's
    # run launches
    "chunk_old": ("pbf_sph_tpu_torch/csrc/micro_chunk.cu", "tools/micro_chunk.py:115"),
    "chunk_new": ("pbf_sph_tpu_torch/csrc/micro_chunk.cu", "tools/micro_chunk.py:115"),
    "chunk_fma": ("pbf_sph_tpu_torch/csrc/micro_chunk.cu", "tools/micro_chunk.py:142"),
    "loop_fma": ("pbf_sph_tpu_torch/csrc/micro_loop.cu", "tools/micro_loop.py:34"),
    "loop_chain": ("pbf_sph_tpu_torch/csrc/micro_loop.cu", "tools/micro_loop.py:34"),
    "loop_op": ("pbf_sph_tpu_torch/csrc/micro_loop.cu", "tools/micro_loop.py:34"),
    # the dense-λ micro-benchmark of tools/micro_dense.py: run's nine FPU
    # bodies, k_mxu, k_wmxu and k_scr
    "dense_loop": ("pbf_sph_tpu_torch/csrc/micro_dense.cu", "tools/micro_dense.py:56"),
    "dense_mxu": ("pbf_sph_tpu_torch/csrc/micro_dense.cu", "tools/micro_dense.py:219"),
    "dense_wmxu": ("pbf_sph_tpu_torch/csrc/micro_dense.cu", "tools/micro_dense.py:326"),
    "dense_scr": ("pbf_sph_tpu_torch/csrc/micro_dense.cu", "tools/micro_dense.py:445"),
    # the compaction building blocks: tools/micro_roll.py's run (k_dyn and
    # k_sta; k_static, k_fori and k_nested in two bodies; k_lam), and
    # tools/micro_vpu.py's rot_kernel, unal_kernel and dma_kernel
    "roll_lanes": ("pbf_sph_tpu_torch/csrc/micro_roll.cu", "tools/micro_roll.py:41"),
    "roll_part_shuffle": ("pbf_sph_tpu_torch/csrc/micro_roll.cu", "tools/micro_roll.py:41"),
    "roll_part_direct": ("pbf_sph_tpu_torch/csrc/micro_roll.cu", "tools/micro_roll.py:41"),
    # k_static, k_fori and k_nested redesigned: a warp per copy, field and
    # chunk, the merge held in registers
    "roll_part_blocked_shuffle": ("pbf_sph_tpu_torch/csrc/micro_roll.cu",
                                  "tools/micro_roll.py:41"),
    "roll_part_blocked_direct": ("pbf_sph_tpu_torch/csrc/micro_roll.cu",
                                 "tools/micro_roll.py:41"),
    "roll_lam": ("pbf_sph_tpu_torch/csrc/micro_roll.cu", "tools/micro_roll.py:41"),
    "vpu_rot": ("pbf_sph_tpu_torch/csrc/micro_roll.cu", "tools/micro_vpu.py:121"),
    "vpu_unal": ("pbf_sph_tpu_torch/csrc/micro_roll.cu", "tools/micro_vpu.py:142"),
    "vpu_dma": ("pbf_sph_tpu_torch/csrc/micro_roll.cu", "tools/micro_vpu.py:169"),
    # the rest of tools/micro_vpu.py: bench_streams, dot_kernel, dot2_kernel
    # and tr_kernel (in two bodies)
    "vpu_streams": ("pbf_sph_tpu_torch/csrc/micro_vpu.cu", "tools/micro_vpu.py:91"),
    "vpu_dot": ("pbf_sph_tpu_torch/csrc/micro_vpu.cu", "tools/micro_vpu.py:196"),
    "vpu_dot2": ("pbf_sph_tpu_torch/csrc/micro_vpu.cu", "tools/micro_vpu.py:219"),
    "vpu_tr_direct": ("pbf_sph_tpu_torch/csrc/micro_vpu.cu", "tools/micro_vpu.py:240"),
    "vpu_tr_restage": ("pbf_sph_tpu_torch/csrc/micro_vpu.cu", "tools/micro_vpu.py:240"),
    # dot_kernel and tr_kernel redesigned: one copy over the card, and a
    # fixed split sum
    "vpu_dot_spread": ("pbf_sph_tpu_torch/csrc/micro_vpu.cu", "tools/micro_vpu.py:196"),
    "vpu_tr_split": ("pbf_sph_tpu_torch/csrc/micro_vpu.cu", "tools/micro_vpu.py:240"),
    "vpu_dot2_spread": ("pbf_sph_tpu_torch/csrc/micro_vpu.cu", "tools/micro_vpu.py:219"),
}
# the variant whose numbers stand in the kernels line for the tiled kernels
TILE_REPORTED = (64, True)
# 3l's states: sort-time dam breaks (count, iterations) and an over-compressed
# 2-cube scene (count, iterations, scaling) whose unions exceed the stage
CELL_STATES = {"dam32k": (32_000, 3), "dam1m": (1_000_000, 6), "over-compressed": None}
OVER_COMPRESSED = (20_000, 2, 1200.0)
# 3m's states: the sort-time dam breaks, and dam32k with seeded colours and a
# seeded 10% of its rows OBSTACLE and 5% dead inside their runs
DIFFUSE_STATES = {"dam32k": (32_000, 3), "dam1m": (1_000_000, 6),
                  "dam32k mixed": (32_000, 3)}

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): device
# memory, and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations per candidate pair in each phase kernel's inner loop, as
# written in csrc/pbf_phases.cu (diffuse: its five sums; the integer cell
# decode is not counted)
FLOP_PER_PAIR = {"lambda": 26, "delta": 34, "diffuse": 5}
# csrc/pbf_tiles.cu, counted over the same per-row candidate pairs as
# lambda/delta (not the tile's larger union-window pairs): the per-pair route
# does the same operations as pbf_phases.cu; the tensor-core route leaves the
# r2 sum (3 multiplies, 2 adds) to the fp64 mma and adds |a|^2 to its result
# (1 operation), so 26 - 5 + 1 and 34 - 5 + 1 stay outside the tensor cores
FLOP_PER_PAIR_TILE = {("lambda", False): 26, ("lambda", True): 22,
                      ("delta", False): 34, ("delta", True): 30}
# csrc/mc_field.cu: every candidate pays l and d2 and the two compares; one
# within h*scale also pays the weight (sqrt, rsqrt) and the nine sums
MC_FLOP_PER_CANDIDATE = 10
MC_FLOP_PER_HIT = 14
# csrc/pbf_phases2.cu: lambda2, delta2 and diffuse2 give the per-row
# kernels' results, so their bound counts the same work: the per-row
# candidate pairs times FLOP_PER_PAIR of the phase they compute, and the
# bytes of the rows, the plan and the output.  The slab lanes beyond the
# per-row pairs are what the design adds; the slab roofline, printed beside
# the bound, reads the slab once and pays only the test that rejects a lane
# on every slab pair (3 differences, r2 as 3 products and 2 adds, the
# compare; diffuse2: the band test's 8 and the compare)
V2_PHASE = {"lambda2": "lambda", "delta2": "delta", "diffuse2": "diffuse",
            "lambda2_cull": "lambda", "delta2_cull": "delta", "diffuse2_cull": "diffuse"}
SLAB_TEST_FLOP = 9
# csrc/anchor_rate.cu: the issue kernels' operations are per round in
# anchor_rate.FLOP_PER_ROUND (an FMA two); the bodies' are the phase kernels'
# FLOP_PER_PAIR; a row of the row kernel does its epilogue (rho 2, the
# gradient scale 3, norm2 5, ci 2, lambda 3)
ROWFIX_FLOP = 15
# csrc/pbf_diffuse_cells.cu: the cell sums add 5 a counted row; the gather
# adds 27 x 5 a gathering row (member, fluid, alive), and a mixed row (count
# > 0.5) pays the rate's divide and 4 x (divide, multiply, subtract,
# multiply, add)
CELL_SUM_FLOP = 5
GATHER_FLOP = 27 * 5
MIX_FLOP = 1 + 4 * 5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok, msg: str) -> None:
    if not bool(ok):
        fail(msg)
    print(f"  ok: {msg}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger of
    the bytes over the memory rate and the operations over the fp32 rate."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of fn() over `reps` calls, after one warm call."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_toolchain() -> None:
    print("== 1. card and toolchain")
    print(card_line())
    from pbf_sph_tpu_torch.ops import cuda_build

    drv = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([cuda_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  driver {drv}")
    print(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout
    print(f"g++: {gxx.strip().splitlines()[0]} (the C++ oracle's compiler, with OpenMP)")


def phase_build() -> None:
    print("== 2. build the CUDA kernels")
    from pbf_sph_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    lib = cuda_build.library()
    print(f"built {cuda_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s; launchers "
          f"{', '.join(n for n in cuda_build.SIGNATURES if getattr(lib, n))}")


def sort_time_state(count: int, iters: int):
    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import (
        TorchSolver, advect_and_sort, dyn_params_of)

    mc, cfg, xs = dam_break(count, solver_iter=iters)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    return spec, dyn, advect_and_sort(spec, state, dyn, scn)


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the 1M-shape numbers."""
    print("== 3. kernels against their plain PyTorch versions, on the card")
    from pbf_sph_tpu_torch.core.types import FLUID
    from pbf_sph_tpu_torch.ops import phases as ph

    report = {"launches_rows": {"diffuse": 0, "lambda": 0, "delta": 0}}
    for count, iters in ((32_000, 3), (1_000_000, 6)):
        spec, dyn, fr = sort_time_state(count, iters)
        st, idx, h = fr.state, fr.index, spec.h
        scale = torch.full((), spec.scale, device=st.mass.device)
        # the per-row diffuse, λ and Δp are off the main path: one round
        # through their wrappers is what counts their launches
        rows = ph.PbfPhases(h)
        rows.diffuse_rows(idx, st.colour, st.ptype, st.alive, dyn["dt"])
        rows.delta_phase(idx, fr.pstar, rows.lambda_phase(idx, fr.pstar, st.mass, st.ptype,
                                                          st.alive),
                         st.ptype, st.alive, scale, dyn["min_bound"], dyn["max_bound"])
        torch.cuda.synchronize()
        for name in report["launches_rows"]:
            report["launches_rows"][name] += rows.launches[name]
        lo, hi = ph.neighbour_ranges(idx)
        pairs = int((hi - lo).sum())
        print(f"dam_break({count}, {iters}): capacity {spec.capacity}, grid "
              f"{spec.grid.dims}, members {int(idx.table[-1])}, "
              f"{pairs} candidate pairs per phase")
        reps = (20, 2) if count > 100_000 else (5, 1)

        nonobs = ph.nonobstacle(st.ptype, st.alive)
        sk = ph.diffuse_kernel(idx, st.colour, nonobs)
        sp = ph.diffuse_plain(idx, st.colour, nonobs)
        err_d = float((sk[:4] - sp[:4]).abs().max())
        check(torch.equal(sk[4], sp[4]), f"diffuse count exact (max {int(sk[4].max())})")
        check(err_d <= 1e-6, f"diffuse colour sums max abs err {err_d:.3e} <= 1e-6")

        lam_k = ph.lambda_kernel(idx, h, fr.pstar, st.mass)
        lam_p = ph.lambda_plain(idx, h, fr.pstar, st.mass)
        err_l = float((lam_k - lam_p).abs().max())
        check(torch.allclose(lam_k, lam_p, atol=1e-6, rtol=1e-5),
              f"lambda max abs err {err_l:.3e} (atol 1e-6, rtol 1e-5)")

        lam = torch.where((st.ptype == FLUID) & st.alive, lam_k, 0.0)
        moved = []
        for delta in (ph.delta_kernel, ph.delta_plain):
            dp = delta(idx, h, fr.pstar, lam)
            moved.append(ph.clamp_to_bounds(fr.pstar, dp, st.ptype, st.alive, scale,
                                            dyn["min_bound"], dyn["max_bound"]))
        err_p = float((moved[0] - moved[1]).abs().max())
        check(err_p <= 1e-5, f"pStar after one delta max abs err {err_p:.3e} <= 1e-5")
        check(bool(torch.isfinite(moved[0]).all()), "pStar after delta is finite")

        index_bytes = nbytes(idx.key, idx.table)
        timings = {
            "diffuse": (lambda: ph.diffuse_kernel(idx, st.colour, nonobs),
                        lambda: ph.diffuse_plain(idx, st.colour, nonobs), err_d,
                        nbytes(st.colour, nonobs, sk)),
            "lambda": (lambda: ph.lambda_kernel(idx, h, fr.pstar, st.mass),
                       lambda: ph.lambda_plain(idx, h, fr.pstar, st.mass), err_l,
                       nbytes(fr.pstar, st.mass, lam_k)),
            "delta": (lambda: ph.delta_kernel(idx, h, fr.pstar, lam),
                      lambda: ph.delta_plain(idx, h, fr.pstar, lam), err_p,
                      nbytes(fr.pstar, lam, fr.pstar)),
        }
        for name, (kern, plain, err, io_bytes) in timings.items():
            ms = device_ms(kern, reps[0])
            plain_ms = device_ms(plain, reps[1])
            bound_ms, bound_by = bound(index_bytes + io_bytes, pairs * FLOP_PER_PAIR[name])
            print(f"  {name}: kernel {ms:.4f} ms ({pairs / ms / 1e6:.3f} Gpairs/s), "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"(capacity {spec.capacity})")
            # no single PyTorch call computes a cell-list neighbour sum
            report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        phase_tiles(spec, dyn, fr, pairs, reps, report)
        phase_v2(spec, dyn, fr, pairs, reps, report)
        del fr, st, idx
        torch.cuda.empty_cache()
    return report


def phase_tiles(spec, dyn, fr, pairs: int, reps, report: dict) -> None:
    """3c: every tiled variant through its wrapper (`PbfPhases`: the cull
    kernels) and the dense kernels through `DenseTiles` (the launches
    counted for their kernels); the cull kernels bit for bit the dense ones
    on member rows; each kernel against its tile plain version (the cull
    kernels' masked by `tile_keep_plain`).  `report` gets the
    lambda_tile/delta_tile/lambda_tile_cull/delta_tile_cull entries, the
    largest error over all variants and the times of TILE_REPORTED, and
    "launches_tile" the counts under those names."""
    print(f"== 3c. tiled kernels against their plain PyTorch versions, "
          f"capacity {spec.capacity}")
    from pbf_sph_tpu_torch.core.types import FLUID
    from pbf_sph_tpu_torch.ops import phases as ph
    from pbf_sph_tpu_torch.ops import tiles as tl

    st, idx, h = fr.state, fr.index, spec.h
    member = idx.key < idx.grid.ncells
    nmember = int(member.sum())
    scale = torch.full((), spec.scale, device=st.mass.device)
    fluid = (st.ptype == FLUID) & st.alive
    bounds = (scale, dyn["min_bound"], dyn["max_bound"])
    launches = report.setdefault("launches_tile", dict.fromkeys(
        ("lambda_tile", "delta_tile", "lambda_tile_cull", "delta_tile_cull"), 0))
    for sub in tl.TILE_SUBS:
        tiles = tl.plan_tiles(idx, sub)
        tpairs = tl.tile_pairs(tiles, sub)
        for mxu in (False, True):
            tag = f"sub {sub} mxu {int(mxu)}"
            args = (tiles, idx, h, fr.pstar)
            phases = ph.PbfPhases(h, sub=sub, mxu=mxu)
            lam_w = phases.lambda_phase(idx, fr.pstar, st.mass, st.ptype, st.alive)
            moved_w = phases.delta_phase(idx, fr.pstar, lam_w, st.ptype, st.alive, *bounds)
            dense = tl.DenseTiles(h, sub, mxu)
            lam_d = dense.lambda_raw(tiles, idx, fr.pstar, st.mass)
            dp_d = dense.delta_raw(tiles, idx, fr.pstar, lam_w)
            torch.cuda.synchronize()
            # PbfPhases counts its cull kernels as lambda_tile/delta_tile
            counts = {"lambda_tile_cull": phases.launches["lambda_tile"],
                      "delta_tile_cull": phases.launches["delta_tile"], **dense.launches}
            for name in launches:
                launches[name] += counts[name]

            # the cull kernels: the dense kernels' raw values on every member
            # row, bit for bit
            lam_c = tl.lambda_tile_cull_kernel(*args, st.mass, sub, mxu)
            check(torch.equal(lam_c[member], lam_d[member]),
                  f"{tag}: lambda_tile_cull bit for bit lambda_tile on {nmember} member rows")
            dp_c = tl.delta_tile_cull_kernel(*args, lam_w, sub, mxu)
            check(torch.equal(dp_c[:, member], dp_d[:, member]),
                  f"{tag}: delta_tile_cull bit for bit delta_tile on {nmember} member rows")

            lam_p = tl.lambda_tile_plain(*args, st.mass, sub, mxu)
            err_l = float((lam_d - lam_p).abs().max())
            check(torch.allclose(lam_d, lam_p, atol=1e-6, rtol=1e-5),
                  f"{tag}: lambda_tile max abs err {err_l:.3e} (atol 1e-6, rtol 1e-5)")
            dp_p = tl.delta_tile_plain(*args, lam_w, sub, mxu)
            moved_p = ph.clamp_to_bounds(fr.pstar, dp_p, st.ptype, st.alive, *bounds)
            moved_d = ph.clamp_to_bounds(fr.pstar, dp_d, st.ptype, st.alive, *bounds)
            err_p = float((moved_d - moved_p).abs().max())
            check(err_p <= 1e-5 and bool(torch.isfinite(moved_d).all()),
                  f"{tag}: pStar after delta_tile max abs err {err_p:.3e} <= 1e-5, finite")
            keep = tl.tile_keep_plain(tiles, idx, fr.pstar, sub, mxu, h)
            kept = tl.kept_tile_pairs(keep, tiles)
            lam_pc = torch.where(fluid, tl.lambda_tile_plain(*args, st.mass, sub, mxu,
                                                             keep=keep), 0.0)
            err_lc = float((lam_w - lam_pc).abs().max())
            check(torch.allclose(lam_w, lam_pc, atol=1e-6, rtol=1e-5),
                  f"{tag}: lambda_tile_cull through PbfPhases max abs err {err_lc:.3e} "
                  f"(atol 1e-6, rtol 1e-5)")
            dp_pc = tl.delta_tile_plain(*args, lam_w, sub, mxu, keep=keep)
            moved_pc = ph.clamp_to_bounds(fr.pstar, dp_pc, st.ptype, st.alive, *bounds)
            err_pc = float((moved_w - moved_pc).abs().max())
            check(err_pc <= 1e-5 and bool(torch.isfinite(moved_w).all()),
                  f"{tag}: pStar after delta_tile_cull through PbfPhases max abs err "
                  f"{err_pc:.3e} <= 1e-5, finite")
            print(f"  {tag}: kept pairs (tile_keep_plain) {kept} ({kept / pairs:.3f}x the "
                  f"{pairs} per-row pairs, {kept / tpairs:.4f} of the {tpairs} tile pairs, "
                  f"{tpairs / pairs:.3f}x)")

            def culled_plain(w, phase):
                return phase(*args, w, sub, mxu,
                             keep=tl.tile_keep_plain(tiles, idx, fr.pstar, sub, mxu, h))

            io = {"lambda": nbytes(fr.pstar, st.mass, lam_w),
                  "delta": nbytes(fr.pstar, lam_w, fr.pstar)}
            times = {
                "lambda_tile": (lambda: tl.lambda_tile_kernel(*args, st.mass, sub, mxu),
                                lambda: tl.lambda_tile_plain(*args, st.mass, sub, mxu),
                                err_l, "lambda", tpairs),
                "delta_tile": (lambda: tl.delta_tile_kernel(*args, lam_w, sub, mxu),
                               lambda: tl.delta_tile_plain(*args, lam_w, sub, mxu),
                               err_p, "delta", tpairs),
                "lambda_tile_cull": (
                    lambda: tl.lambda_tile_cull_kernel(*args, st.mass, sub, mxu),
                    lambda: culled_plain(st.mass, tl.lambda_tile_plain), err_lc, "lambda",
                    kept),
                "delta_tile_cull": (
                    lambda: tl.delta_tile_cull_kernel(*args, lam_w, sub, mxu),
                    lambda: culled_plain(lam_w, tl.delta_tile_plain), err_pc, "delta", kept),
            }
            for name, (kern, plain, err, phase, walked) in times.items():
                ms = device_ms(kern, reps[0])
                plain_ms = device_ms(plain, 1, warm=False)
                bound_ms, bound_by = bound(nbytes(idx.key, tiles) + io[phase],
                                           pairs * FLOP_PER_PAIR_TILE[phase, mxu])
                walked_ms, walked_by = bound(nbytes(idx.key, tiles) + io[phase],
                                             walked * FLOP_PER_PAIR_TILE[phase, mxu])
                print(f"  {name} {tag}: kernel {ms:.4f} ms ({pairs / ms / 1e6:.3f} G per-row "
                      f"pairs/s, {walked / ms / 1e6:.3f} G walked pairs/s), plain "
                      f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} (the walked "
                      f"pairs' chain {walked_ms:.4f} ms by {walked_by})")
                entry = report.setdefault(name, dict(max_abs_err=0.0))
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                if (sub, mxu) == TILE_REPORTED:
                    # no single PyTorch call computes a cell-list neighbour sum
                    entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=None)
            del phases, dense, lam_w, moved_w, lam_d, dp_d, lam_c, dp_c, lam_p, dp_p
            del moved_p, moved_d, keep, lam_pc, dp_pc, moved_pc
        del tiles
        torch.cuda.empty_cache()
    print(f"  tiled launches so far: {launches}")


def phase_v2(spec, dyn, fr, pairs: int, reps, report: dict) -> None:
    """3d: the v2 chain (plan, compact pStar, lambda2, compact lambda, delta2,
    diffuse2) once through the `PbfPhases2` wrappers and the dense lambda2,
    delta2 and diffuse2 once through `DensePhases2` (the launches counted
    for their kernels), then each kernel against its plain version on the
    same inputs and the cull kernels against the dense ones; `report` gets
    the compact/lambda2/delta2/diffuse2 entries and their _cull entries (the
    largest error over both states, this state's times) and "launches_v2"
    the wrappers' counts under those names."""
    print(f"== 3d. v2 compacted-candidate kernels against their plain PyTorch "
          f"versions, capacity {spec.capacity}")
    from pbf_sph_tpu_torch.ops import phases as ph
    from pbf_sph_tpu_torch.ops.grid import decode_key
    from pbf_sph_tpu_torch.tools import phases2 as p2
    from pbf_sph_tpu_torch.tools.bench_phases import grown_plan

    st, idx, h = fr.state, fr.index, spec.h
    cells, member = decode_key(idx.key, spec.grid)
    bounds = (torch.full((), spec.scale, device=st.mass.device), dyn["min_bound"],
              dyn["max_bound"])
    phases, wins, smax, wcap, _ = grown_plan(spec, idx)
    nchunkp = wins["nchunkp"]
    spairs = p2.slab_pairs(wins)
    defined = (torch.arange(wcap, device=nchunkp.device)
               < nchunkp[:, None] * p2.WCOL).reshape(-1)
    ncols = int(defined.sum())
    print(f"smax {smax}, wcap {wcap}: nchunkp mean {float(nchunkp.float().mean()):.2f}, "
          f"max {int(nchunkp.max())}; {spairs} slab pairs ({spairs / pairs:.2f}x the "
          f"per-row pairs)")

    cands = phases.compact_pstar(wins, fr.pstar, member)
    lam = phases.lambda_phase(wins, cands, fr.pstar, st.mass, member, st.ptype, st.alive)
    lamc = phases.compact_lam(wins, lam)
    phases.delta_phase(wins, cands, lamc, fr.pstar, lam, member, st.ptype, st.alive,
                       *bounds)
    phases.diffuse(wins, st.colour, cells, member, st.ptype, st.alive, dyn["dt"])
    rows_l = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], st.mass], dim=1)
    rows_d = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], lam], dim=1)
    dims = spec.grid.dims
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, dims)
    cands_c = p2.compact_kernel(wins, st.colour)
    cands_w = p2.compact_kernel(wins, wpack)
    dense = p2.DensePhases2(h)
    lam_k = dense.lambda_raw(nchunkp, rows_l, cands)
    dp_k = dense.delta_raw(nchunkp, rows_d, cands, lamc)
    sk = dense.diffuse_raw(nchunkp, cl, cands_c, cands_w, dims)
    torch.cuda.synchronize()
    # PbfPhases2 counts its cull kernels as lambda2/delta2/diffuse2
    counts = {"compact": phases.launches["compact"],
              "lambda2_cull": phases.launches["lambda2"],
              "delta2_cull": phases.launches["delta2"],
              "diffuse2_cull": phases.launches["diffuse2"], **dense.launches}
    launches = report.setdefault("launches_v2", dict.fromkeys(counts, 0))
    for name in launches:
        launches[name] += counts[name]

    # the compaction, for the 4-field pStar pack and the 1-field lambda pack
    packs = {"pStar": p2.pstar_pack(fr.pstar, member), "lambda": lam.reshape(1, -1)}
    for name, packed in packs.items():
        same = torch.equal(p2.compact_kernel(wins, packed)[:, defined],
                           p2.compact_plain(wins, packed)[:, defined])
        check(same, f"compact {name} ({packed.shape[0]} fields) bit for bit on the "
                    f"{ncols} columns below nchunkp*128")

    lam_p = p2.lambda2_plain(nchunkp, rows_l, cands, h)
    err_l = float((lam_k - lam_p).abs().max())
    check(torch.allclose(lam_k, lam_p, atol=1e-6, rtol=1e-5),
          f"lambda2 max abs err {err_l:.3e} (atol 1e-6, rtol 1e-5)")

    dp_p = p2.delta2_plain(nchunkp, rows_d, cands, lamc, h)
    moved = [ph.clamp_to_bounds(fr.pstar, dp, st.ptype, st.alive & member, *bounds)
             for dp in (dp_k, dp_p)]
    err_p = float((moved[0] - moved[1]).abs().max())
    check(err_p <= 1e-5 and bool(torch.isfinite(moved[0]).all()),
          f"pStar after delta2 and the clamp max abs err {err_p:.3e} <= 1e-5, finite")

    # the cull kernels: the dense kernels' raw values on every member row, bit
    # for bit, and their plain versions' there (non-member rows are masked)
    nmember = int(member.sum())
    lam_c = p2.lambda2_cull_kernel(nchunkp, rows_l, cands, member, h)
    check(torch.equal(lam_c[member], lam_k[member]),
          f"lambda2_cull bit for bit lambda2 on {nmember} member rows")
    err_lc = float((lam_c - lam_p)[member].abs().max())
    check(torch.allclose(lam_c[member], lam_p[member], atol=1e-6, rtol=1e-5),
          f"lambda2_cull max abs err {err_lc:.3e} on member rows (atol 1e-6, rtol 1e-5)")
    dp_c = p2.delta2_cull_kernel(nchunkp, rows_d, cands, lamc, member, h)
    check(torch.equal(dp_c[:, member], dp_k[:, member]),
          f"delta2_cull bit for bit delta2 on {nmember} member rows")
    moved_c = ph.clamp_to_bounds(fr.pstar, dp_c, st.ptype, st.alive & member, *bounds)
    err_pc = float((moved_c - moved[1]).abs().max())
    check(err_pc <= 1e-5 and bool(torch.isfinite(moved_c).all()),
          f"pStar after delta2_cull and the clamp max abs err {err_pc:.3e} <= 1e-5, finite")
    kept = p2.kept_pairs(nchunkp, rows_l, member, cands, h)
    print(f"  kept pairs (cull_keep_plain) {kept} ({kept / spairs:.4f} of the {spairs} slab pairs, "
          f"{kept / pairs:.3f}x the {pairs} per-row pairs)")

    sp = p2.diffuse2_plain(nchunkp, cl, cands_c, cands_w, dims)
    err_d = float((sk[:4] - sp[:4]).abs().max())
    check(torch.equal(sk[4], sp[4]), f"diffuse2 count exact (max {int(sk[4].max())})")
    check(err_d <= 1e-6, f"diffuse2 colour sums max abs err {err_d:.3e} <= 1e-6")

    # the diffuse2 cull kernel: the dense sums on every member row bit for
    # bit, the plain version's there, and the plain version masked by its
    # keep mask on every row
    sk_c = p2.diffuse2_cull_kernel(nchunkp, cl, cands_c, cands_w, member, dims)
    check(torch.equal(sk_c[:, member], sk[:, member]),
          f"diffuse2_cull bit for bit diffuse2 on {nmember} member rows")
    err_dc = float((sk_c[:4] - sp[:4])[:, member].abs().max())
    check(torch.equal(sk_c[4][member], sp[4][member]) and err_dc <= 1e-6,
          f"diffuse2_cull count exact, colour sums max abs err {err_dc:.3e} <= 1e-6 on "
          f"member rows")
    keep = p2.diffuse_keep_plain(nchunkp, cl, member, cands_w, dims)
    masked = p2.diffuse2_plain(nchunkp, cl, cands_c, cands_w, dims, keep=keep)
    err_m = float((sk_c[:4] - masked[:4]).abs().max())
    check(torch.equal(sk_c[4], masked[4]) and err_m <= 1e-6,
          f"diffuse2_cull against diffuse2_plain masked by diffuse_keep_plain on every row: "
          f"count exact, sums max abs err {err_m:.3e} <= 1e-6")
    slot_cols = int(keep.sum())  # the slots the slot test passes, in columns
    kept_d = slot_cols * p2.SUB
    print(f"  diffuse2 kept pairs (diffuse_keep_plain) {kept_d} "
          f"({kept_d / spairs:.4f} of the {spairs} slab pairs, "
          f"{kept_d / pairs:.3f}x the {pairs} per-row pairs); the slot "
          f"test passes {slot_cols / ncols:.4f} of the {ncols} columns")

    # the one PyTorch call that computes the pStar slab: index_select over the
    # plan's column map, with SENTINEL as one more column of the pack
    packed = packs["pStar"]
    n = packed.shape[1]
    colmap = p2.source_columns(wins)[..., None] + torch.arange(p2.WCOL, device=cl.device)
    used = torch.arange(wcap // p2.WCOL, device=cl.device) < wins["nchunk"][:, None]
    colmap = torch.where(used[..., None], colmap, n).reshape(-1)
    packed_ext = torch.cat([packed, torch.full_like(packed[:, :1], p2.SENTINEL)], dim=1)
    check(torch.equal(torch.index_select(packed_ext, 1, colmap)[:, defined],
                      p2.compact_kernel(wins, packed)[:, defined]),
          "index_select over the column map gives the pStar slab")
    plan_bytes = nbytes(wins["meta"], wins["nchunk"], nchunkp, wins["sstart"])
    col_bytes = 4 * ncols  # one fp32 slab field over the defined columns
    # name: kernel, plain, error, bound bytes, the dense kernel's own bytes
    # (rows, nchunkp, the slab fields it reads, its output), library call
    timings = {
        "compact": (lambda: p2.compact_kernel(wins, packed),
                    lambda: p2.compact_plain(wins, packed), 0.0,
                    nbytes(packed) + plan_bytes + 4 * col_bytes, 0,
                    lambda: torch.index_select(packed_ext, 1, colmap)),
        "lambda2": (lambda: p2.lambda2_kernel(nchunkp, rows_l, cands, h),
                    lambda: p2.lambda2_plain(nchunkp, rows_l, cands, h), err_l,
                    nbytes(rows_l, lam_k) + plan_bytes,
                    nbytes(rows_l, nchunkp, lam_k) + 3 * col_bytes, None),
        "delta2": (lambda: p2.delta2_kernel(nchunkp, rows_d, cands, lamc, h),
                   lambda: p2.delta2_plain(nchunkp, rows_d, cands, lamc, h), err_p,
                   nbytes(rows_d, moved[0]) + plan_bytes,
                   nbytes(rows_d, nchunkp, moved[0]) + 4 * col_bytes, None),
        # the same plain versions as lambda2/delta2, timed once there
        "lambda2_cull": (lambda: p2.lambda2_cull_kernel(nchunkp, rows_l, cands, member, h),
                         None, err_lc, nbytes(rows_l, member, lam_c) + plan_bytes,
                         nbytes(rows_l, member, nchunkp, lam_c) + 3 * col_bytes, None),
        "delta2_cull": (lambda: p2.delta2_cull_kernel(nchunkp, rows_d, cands, lamc, member,
                                                      h),
                        None, err_pc, nbytes(rows_d, member, moved_c) + plan_bytes,
                        nbytes(rows_d, member, nchunkp, moved_c) + 4 * col_bytes, None),
        "diffuse2": (lambda: p2.diffuse2_kernel(nchunkp, cl, cands_c, cands_w, dims),
                     lambda: p2.diffuse2_plain(nchunkp, cl, cands_c, cands_w, dims), err_d,
                     nbytes(cl, st.colour, wpack, sk) + plan_bytes,
                     nbytes(cl, nchunkp, sk) + 6 * col_bytes, None),
        # its slab read: [w, bcl] over the defined columns and the colours of
        # the kept slots (the kept read)
        "diffuse2_cull": (
            lambda: p2.diffuse2_cull_kernel(nchunkp, cl, cands_c, cands_w, member, dims),
            None, err_dc, nbytes(cl, member, st.colour, wpack, sk_c) + plan_bytes,
            nbytes(cl, member, nchunkp, sk_c) + 2 * col_bytes + 16 * slot_cols, None),
    }
    kept_of = {"lambda2_cull": kept, "delta2_cull": kept, "diffuse2_cull": kept_d}
    for name, (kern, plain, err, io_bytes, slab_bytes, library) in timings.items():
        ms = device_ms(kern, reps[0])
        plain_ms = (device_ms(plain, 1) if plain is not None
                    else report[name.removesuffix("_cull")]["plain_ms"])
        library_ms = device_ms(library, reps[0]) if library is not None else None
        if name == "compact":
            bound_ms, bound_by = bound(io_bytes, 0)
            rate = f"{io_bytes / ms / 1e6:.1f} GB/s of the bound's bytes"
        else:
            bound_ms, bound_by = bound(io_bytes, pairs * FLOP_PER_PAIR[V2_PHASE[name]])
            slab_ms, slab_by = bound(slab_bytes, spairs * SLAB_TEST_FLOP)
            rate = (f"{spairs / ms / 1e6:.3f} G slab pairs/s, {pairs / ms / 1e6:.3f} G "
                    f"per-row pairs/s; slab roofline {slab_ms:.4f} ms by {slab_by}")
            if name.endswith("_cull"):
                k = kept_of[name]
                kept_ms, kept_by = bound(slab_bytes, k * FLOP_PER_PAIR[V2_PHASE[name]])
                read = ("the kept read" if name == "diffuse2_cull" else "the slab read")
                rate += (f"; {k / ms / 1e6:.3f} G kept pairs/s, {read} and the "
                         f"kept pairs' chain {kept_ms:.4f} ms by {kept_by}")
        lib = f", index_select {library_ms:.4f} ms" if library_ms is not None else ""
        print(f"  {name}: kernel {ms:.4f} ms ({rate}), plain {plain_ms:.4f} ms{lib}, "
              f"bound {bound_ms:.4f} ms by {bound_by}")
        entry = report.setdefault(name, dict(max_abs_err=0.0))
        # no single PyTorch call computes a cell-list pair sum (lambda2, delta2,
        # diffuse2)
        entry.update(max_abs_err=max(entry["max_abs_err"], err), ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    del phases, wins, cands, lamc, cands_c, cands_w, packs, packed_ext, colmap
    torch.cuda.empty_cache()
    print(f"  v2 wrapper launches so far: {launches}")


def phase_anchor():
    """3e: the rate-anchor kernels (csrc/anchor_rate.cu): the SASS of each
    (cuobjdump), each against its plain version on the card (uncounted; the
    blocked body also bit for bit the body kernel), then one rate reading of
    each through `Anchor`'s wrappers at the tool's sizes and the blocked λ
    body at the λ body's work (the launches counted for these kernels).
    Returns (report, launches)."""
    print("== 3e. rate-anchor kernels (csrc/anchor_rate.cu) against their plain PyTorch "
          "versions")
    from pbf_sph_tpu_torch.ops import cuda_build
    from pbf_sph_tpu_torch.tools import anchor_rate as ar

    t0 = time.perf_counter()
    for name, r in ar.check_sass(cuda_build.library_path()).items():
        check(r["ok"], f"SASS {name}: " + ", ".join(
            f"{k} {v}" for k, v in r.items() if k != "ok"))
    device = torch.device("cuda", torch.cuda.current_device())
    errs = dict.fromkeys(ar.KERNELS, 0.0)
    # the blocked bodies' rtol on each of their cases (n eps on the tool's inputs)
    rtols = {f"body_blocked {which} {tag}": rtol for which in ("lambda", "delta")
             for tag, _, _, rtol in ar.blocked_cases(device)}
    for label, (err, ok) in ar.card_parity(device).items():
        if label.endswith("= anchor_body"):
            check(ok and err == 0, f"{label}: max abs err {err:.3e} (bit for bit)")
            continue
        tol = ("atol 1e-9" if label.startswith("rowfix")
               else f"rtol {rtols.get(label, 1e-5):.3g}, atol 1e-6")
        check(ok, f"{label}: max abs err {err:.3e} ({tol})")
        name = "anchor_" + label.split()[0]
        errs[name] = max(errs[name], err)

    anchor = ar.Anchor()
    rates = ar.read_rates(anchor, ar.DAM1M_DIMS, 5, device)
    x, rows, strip, frows = ar.tool_inputs(device)
    # the blocked λ body at the work of the λ body's larger size
    lam = rates["body"]["lambda"]
    n_lam, it_lam = lam["threads"], lam["iters"][1]
    nunroll = ar.BODY_SHAPE["nunroll"]
    n_blk, it_blk = ar.blocked_shape(n_lam, it_lam)
    blocked_ms = ar.held_ms(
        lambda: anchor.body_blocked(rows, strip, "lambda", nunroll, it_blk, 0, n_blk), 5)
    torch.cuda.synchronize()
    launches = dict(anchor.launches)
    index = ar.rowfix_index(frows)
    fma = rates["issue"]["fma 16x16"]
    print(f"  SM clock beside the rate runs (nvidia-smi, MHz): {rates['clocks_sm_mhz']}")
    for name, r in rates["issue"].items():
        lat = f", {r['ns_per_op']:.3f} ns a dependent op" if "ns_per_op" in r else ""
        print(f"  issue {name}: {r['rate'] / 1e12:.3f} T ops/s ({r['rate'] / fma['rate']:.3f} "
              f"of fma){lat}")
    for which, r in rates["body"].items():
        blk = rates["blocked"][which]
        print(f"  body {which}: {r['rate'] / 1e9:.1f} G pair-slots/s; blocked "
              f"({ar.BLOCKED_ROWS} rows a thread, {blk['threads']} threads) "
              f"{blk['rate'] / 1e9:.1f}, {blk['rate'] / r['rate']:.3f}x")
    print(f"  rowfix: {rates['rowfix']['ns_per_row']:.5f} ns a row")

    # the numbers of the kernels line: fma 16x16, the λ body, rowfix, each at
    # the larger of its two sizes; the blocked λ body at the λ body's work
    n_fma, it_fma = fma["threads"], fma["iters"][1]
    nb = rates["rowfix"]["blocks"][1]
    body_flops = n_lam * nunroll * ar.WCOL * it_lam * FLOP_PER_PAIR["lambda"]
    body_bound = bound(nbytes(rows, strip) + 4 * n_lam, body_flops)
    table = {
        "anchor_issue": (
            fma["ms"][1], lambda: ar.issue_plain(x, "fma", 16, 16, it_fma),
            bound(nbytes(x) + 4 * n_fma, n_fma * 256 * it_fma * ar.FLOP_PER_ROUND["fma"])),
        "anchor_body": (
            lam["ms"][1], lambda: ar.body_plain(rows, strip, "lambda", nunroll, it_lam),
            body_bound),
        # the same pairs: n_lam threads of BLOCKED_ROWS rows, it_lam /
        # BLOCKED_ROWS iterations; its output is BLOCKED_ROWS x as long
        "anchor_body_blocked": (
            blocked_ms, lambda: ar.body_plain(rows, strip, "lambda", nunroll, it_lam),
            bound(nbytes(rows, strip) + 4 * n_blk * ar.BLOCKED_ROWS, body_flops)),
        # the row kernel reads each row's key and float4 and only the table
        # entries at the ends of its rows' ranges, and writes one λ a thread
        "anchor_rowfix": (
            rates["rowfix"]["ms"][1], lambda: ar.rowfix_plain(frows, index, nb),
            bound(20 * ar.ROWS + 4 * ar.rowfix_table_entries(index) + 4 * nb * ar.ROWS,
                  nb * ar.ROWS * ROWFIX_FLOP)),
    }
    report = {}
    for name, (ms, plain, (bound_ms, bound_by)) in table.items():
        plain_ms = device_ms(plain, 1, warm=False)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {bound_by}")
        # no single PyTorch call computes these chains
        report[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"  anchor_body_blocked at the λ body's work ({n_blk} threads x {ar.BLOCKED_ROWS} "
          f"rows, {it_blk} iterations): {lam['ms'][1] / blocked_ms:.3f}x faster than "
          f"anchor_body, {body_bound[0] / blocked_ms:.3f} of the bound")
    print(f"  rate-anchor wrapper launches: {launches}")
    print(f"  3e wall time: {time.perf_counter() - t0:.2f} s")
    return report, launches


def phase_window():
    """3f: the window micro-benchmark kernels (csrc/micro_window.cu): the SASS
    of each body at both widths (cuobjdump), each against its plain version
    on the card and each blocked kernel bit for bit its original (uncounted),
    then one scenario-A reading of each through `MicroWindow` (the launches
    counted for these kernels).  Returns (report, launches)."""
    print("== 3f. window micro-benchmark kernels (csrc/micro_window.cu) against their plain "
          "PyTorch versions")
    from pbf_sph_tpu_torch.ops import cuda_build
    from pbf_sph_tpu_torch.tools import bench_cells as bc
    from pbf_sph_tpu_torch.tools import micro_window as mw

    t0 = time.perf_counter()
    for name, r in mw.check_sass(cuda_build.library_path()).items():
        check(r["ok"], f"SASS {name}: " + ", ".join(
            f"{k} {v}" for k, v in r.items() if k != "ok"))
    device = torch.device("cuda", torch.cuda.current_device())
    errs = dict.fromkeys(mw.KERNELS, 0.0)
    for label, (err, ok) in mw.card_parity(device).items():
        check(ok, f"{label}: max abs err {err:.3e} (rtol {mw.RTOL}, atol {mw.ATOL})")
        name = mw.KERNEL_OF[label.split()[0]]
        errs[name] = max(errs[name], err)
    bits = mw.blocked_bits(device)
    for label, (err, same) in bits.items():
        check(same, f"{label}: max abs err {err:.3e} (bit for bit)")
    print(f"  blocked kernels bit for bit their originals on every block of nblocks "
          f"{mw.BITS_BLOCKS}: {len(bits)} cases, max abs err "
          f"{max(e for e, _ in bits.values()):.3e}")

    win = mw.MicroWindow()
    rates = mw.read_scenario_a(win, device, 5)
    torch.cuda.synchronize()
    launches = dict(win.launches)
    print(f"  SM clock beside the readings (nvidia-smi, MHz): {rates['clocks_sm_mhz']}")
    x = mw.tool_inputs(device)
    nb = mw.TOOL_BLOCKS[1]
    report = {}
    for body in mw.ALL_BODIES:
        r = rates[body]
        cand = x.pack if body in mw.FUSED else x.strip
        tables = ((x.tbl,) if body in mw.FLAT_BODIES else () if body in mw.STATIC_BODIES
                  else (x.wins,))
        # each input read once (the table, the rows, the candidates), one λ
        # a thread written; the operations of every pair slot the body computes
        bound_ms, bound_by = bound(nbytes(*tables, x.rows, cand) + 4 * nb * mw.ROWS,
                                   mw.body_pairs(body, x, nb) * FLOP_PER_PAIR["lambda"])
        plain_ms = device_ms(lambda: mw.run_plain(body, x, nb), 1, warm=False)
        print(f"  {body}: {r['ns_per_chunk']:.4f} ns a chunk ({r['chunks_per_sub']:g} a "
              f"sub-block), {r['pair_slots_per_s'] / 1e9:.1f} G pair-slots/s; kernel "
              f"{r['ms'][1]:.4f} ms at nblocks {nb}, plain {plain_ms:.4f} ms (one block), "
              f"bound {bound_ms:.4f} ms by {bound_by}")
        if body in mw.BLOCKED_OF:
            orig = rates[mw.BLOCKED_OF[body]]["ms"][1]
            pairs = mw.body_pairs(body, x, nb)
            print(f"    {body}: {orig / r['ms'][1]:.3f}x {mw.BLOCKED_OF[body]} ({orig:.4f} ms), "
                  f"{bound_ms / r['ms'][1]:.3f} of the bound; anchored at 7b-b's λ ceiling "
                  f"{pairs / bc.CELLS_CEILING['lambda'] * 1e3:.4f} ms")
        if body not in ("prod", "guarded", "flat", "static", "prod_blocked", "guarded_blocked",
                        "flat_blocked", "static_blocked"):
            continue  # the line holds the JAX tool's body of each kernel, flat's split one
        # no single PyTorch call computes this chain
        report[mw.KERNEL_OF[body]] = dict(
            max_abs_err=errs[mw.KERNEL_OF[body]], ms=r["ms"][1], plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"  window wrapper launches: {launches}")
    print(f"  3f wall time: {time.perf_counter() - t0:.2f} s")
    return report, launches


def finalised_state(workload: str):
    """The sort-time frame and the finalised state of one frame of a surface
    workload on the card: what the MC field reads."""
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import (
        TorchSolver, dyn_params_of, solve_frame)

    mc, cfg, xs = WORKLOADS[workload]()
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    fr, st, _ = solve_frame(spec, solver.phases, state, dyn, scn)
    return spec, dyn, fr, st


def phase_mc_field():
    """Row 4's MC field kernel against its plain version; returns the mc128k
    numbers, the mc128k lattice (spec, dyn, frame, v, n, c) and each
    workload's (spec, frame, finalised state, dyn)."""
    print("== 3b. row 4's MC field kernel against its plain PyTorch version, on the card")
    from pbf_sph_tpu_torch.ops import mc_field as mf
    from pbf_sph_tpu_torch.ops import phases as ph

    report = lattice = None
    states = {}
    row4_at_start = mf.ROW4_LAUNCHES["mc_field"]
    for workload in ("bench20k", "mc128k"):
        spec, dyn, fr, st = finalised_state(workload)
        states[workload] = (spec, fr, st, dyn)
        mc = spec.surface
        nonobs = ph.nonobstacle(st.ptype, st.alive)
        args = (fr.index, mc, spec.h, spec.scale, st.position, st.colour, nonobs,
                fr.min_extent)
        raw_k = mf.mc_field_kernel(*args)
        raw_p = mf.mc_field_plain(*args)
        _, cell, skip = mf.lattice_nodes(mc, spec.grid.extent, st.position.device)
        lo, hi, _ = mf.node_ranges(fr.index, cell, skip)
        pairs, hits = int((hi - lo).sum()), int(raw_p[8].sum())
        print(f"{workload}: res {mc.resolution}, lattice {mc.sample} "
              f"({skip.numel()} nodes), grid {spec.grid.dims}, "
              f"{int(fr.index.table[-1])} members, {pairs} node-candidate pairs, "
              f"{hits} within h*scale")
        check(torch.equal(raw_k[8], raw_p[8]),
              f"count exact (max {int(raw_p[8].max())})")
        err_s = float((raw_k[:4] - raw_p[:4]).abs().max())
        check(torch.allclose(raw_k[:4], raw_p[:4], rtol=1e-4, atol=1e-3),
              f"S0 and S max abs err {err_s:.3e} (rtol 1e-4, atol 1e-3)")
        err_c = float((raw_k[4:8] - raw_p[4:8]).abs().max())
        check(torch.allclose(raw_k[4:8], raw_p[4:8], rtol=1e-4, atol=1e-3),
              f"colour sums max abs err {err_c:.3e} (rtol 1e-4, atol 1e-3)")

        size = dyn["mc_particle_size"]
        vk, nk, ck = mf.post_pass(raw_k, mc, spec.grid.extent, size)
        vp, np_, cp = mf.post_pass(raw_p, mc, spec.grid.extent, size)
        check(torch.allclose(vk, vp, rtol=1e-4, atol=1e-3), "v (rtol 1e-4, atol 1e-3)")
        active = vp > 1e-3
        for name, got, want in (("n", nk, np_), ("c", ck, cp)):
            disagree = float((torch.isfinite(got) != torch.isfinite(want)).float().mean())
            m = torch.isfinite(want) & active
            check(disagree < 0.01 and torch.allclose(got[m], want[m], rtol=1e-3,
                                                      atol=1e-3),
                  f"{name}: NaN disagreement {disagree:.2e} < 1%, finite active nodes "
                  f"rtol 1e-3, atol 1e-3")
        check(int(skip.sum()) == 1 and float(vk[skip]) == 0
              and bool((nk[:, skip] == 0).all()) and bool((ck[:, skip] == 0).all()),
              "the skip node is 0")

        ms = device_ms(lambda: mf.mc_field_kernel(*args), 20)
        plain_ms = device_ms(lambda: mf.mc_field_plain(*args), 2)
        bound_ms, bound_by = bound(
            nbytes(st.position, st.colour, nonobs, fr.index.key, fr.index.table,
                   fr.min_extent, raw_k),
            pairs * MC_FLOP_PER_CANDIDATE + hits * MC_FLOP_PER_HIT)
        print(f"  mc_field: kernel {ms:.4f} ms ({pairs / ms / 1e6:.3f} G node-candidate "
              f"pairs/s), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}")
        # no single PyTorch call computes a cell-list neighbour sum
        report = dict(max_abs_err=max(err_s, err_c), ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        lattice = (spec, dyn, fr, vk, nk, ck)
    report["phase_launches"] = mf.ROW4_LAUNCHES["mc_field"] - row4_at_start
    check(report["phase_launches"] > 0, f"3b launched mc_field {report['phase_launches']} times")
    return report, lattice, states


def phase_mc_bisect(states):
    """3g: the MC-field bisection kernels (csrc/mc_field.cu): the SASS
    (cuobjdump), each against its plain version on 3b's states (uncounted),
    then one kernel-ladder reading at mc128k through `McFieldBisect` and
    noop's turns beside torch.zeros (the launches counted for these
    kernels).  Returns (report, launches)."""
    print("== 3g. MC-field bisection kernels (csrc/mc_field.cu) against their plain PyTorch "
          "versions")
    from pbf_sph_tpu_torch.ops import cuda_build
    from pbf_sph_tpu_torch.tools import micro_mc_field as mcb

    for name, r in mcb.check_sass(cuda_build.library_path()).items():
        check(r["ok"], f"SASS {name}: " + ", ".join(
            f"{k} {v}" for k, v in r.items() if k not in ("ok", "opcodes", "parent")))
    errs = dict.fromkeys(mcb.KERNELS, 0.0)
    for workload, (spec, fr, st, _) in states.items():
        for label, (err, ok) in mcb.card_parity(spec, fr, st, workload).items():
            check(ok, f"{label}: max abs err {err:.3e} (noop zero, rows bit for bit, loops "
                      f"rtol {mcb.RTOL} with atol {mcb.ATOL_SCALE} x max|value|, zero_fill "
                      f"equal to noop_plain)")
            name = mcb.KERNEL_OF[label.split()[0]]
            errs[name] = max(errs[name], err)

    spec, fr, st, _ = states["mc128k"]
    bisect = mcb.McFieldBisect(spec.h)
    ladder = mcb.kernel_ladder(bisect, spec, fr, st, 10)
    torch.cuda.synchronize()
    print(f"  SM clock beside the ladder (nvidia-smi, MHz): {ladder['clocks_sm_mhz']}")
    args = mcb.field_args(spec, fr, st)
    nodes = int(np.prod(spec.surface.sample))
    report = {}
    for r in ladder["steps"]:
        print(f"  {r['step']}: {r['events_ms']:.4f} ms back to back, {r['graph_ms']:.4f} ms in "
              f"a graph (step {r['step_graph_ms']:+.4f}: {r['adds']}), host "
              f"{r['host_us']:.2f} us a launch, bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
        if r["step"] == "full":
            continue
        plain = mcb.PLAIN[r["step"]]
        plain_ms = device_ms(lambda: plain(*args), 1)
        name = mcb.KERNEL_OF[r["step"]]
        report[name] = dict(max_abs_err=errs[name], ms=r["graph_ms"], plain_ms=plain_ms,
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
        print(f"  {name}: plain {plain_ms:.4f} ms")
    # torch.zeros computes what noop and its redesign zero_fill write (no
    # PyTorch call computes the others): the three read in turns by the
    # ladder's reader, a CUDA graph
    turns = mcb.noop_turns(bisect, spec, fr, st)
    torch.cuda.synchronize()
    launches = dict(bisect.launches)
    med = {k: float(np.median(v)) for k, v in turns.items()}
    for k, v in turns.items():
        print(f"  {k} in {len(v)} turns (ms in a graph of {mcb.GRAPH_LAUNCHES}): median "
              f"{med[k]:.5f}, min-max {min(v):.5f}-{max(v):.5f}: " + ", ".join(
                  f"{t:.5f}" for t in v))
    for body in ("noop", "zero_fill"):
        print(f"  {mcb.KERNEL_OF[body]} loses to torch.zeros((9, {nodes})) (median over by > "
              f"5%, ranges apart): {mcb.noop_loses(turns, body=body)}")
    noop = report["mc_field_noop"]
    noop.update(ms=med["noop"], library_ms=med["zeros"])
    report["mc_field_zero_fill"] = dict(
        max_abs_err=errs["mc_field_zero_fill"], ms=med["zero_fill"],
        plain_ms=device_ms(lambda: mcb.noop_plain(*args), 1), bound_ms=noop["bound_ms"],
        bound_by=noop["bound_by"], library_ms=med["zeros"])
    print(f"  mc_field_zero_fill: plain {report['mc_field_zero_fill']['plain_ms']:.4f} ms, "
          f"bound {noop['bound_ms']:.4f} ms by {noop['bound_by']} (noop's output)")
    print(f"  bisection wrapper launches: {launches}")
    return report, launches


def phase_mc_field_cells(states) -> dict:
    """3n: row 4b, the main path's MC field (csrc/mc_field_cells.cu), on 3b's
    states: against its plain version and row 4 (`cells_agree`), two
    launches bit for bit, then the kernel and the whole call in turns beside
    row 4's (`cells_turns`), with the host ms a call, pairs/s and the bound.
    Returns the mc128k numbers of the kernels line."""
    print("== 3n. the main path's MC field (csrc/mc_field_cells.cu, row 4b) against its plain "
          "PyTorch version and row 4")
    from pbf_sph_tpu_torch.ops import mc_field as mf
    from pbf_sph_tpu_torch.tools import micro_mc_field as mcb

    report = None
    err_plain = 0.0
    for workload in ("bench20k", "mc128k"):
        spec, fr, st, dyn = states[workload]
        mc, size = spec.surface, dyn["mc_particle_size"]
        args = mcb.cells_args(spec, fr, st, size)
        got, again = mf.mc_field_cells_kernel(*args), mf.mc_field_cells_kernel(*args)
        want = mf.mc_field_cells_plain(*args)
        raw = mf.mc_field_kernel(*mcb.field_args(spec, fr, st))
        _, _, skip = mf.lattice_nodes(mc, spec.grid.extent, st.position.device)
        cen, cen4 = mcb.census(spec, fr, raw, clamped=True), mcb.census(spec, fr, raw)
        print(f"{workload}: G {mf.CELLS_LANES}; {cen['pairs']} node-candidate "
              f"pairs over the clamped ranges (row 4's ranges {cen4['pairs']}), {cen['live']} "
              f"live nodes, {cen['per_live']:.2f} a live node (max {cen['max_per_node']}), "
              f"{cen['hits']} within h*scale")
        for ref, vnc in (("its plain version", (want[0], want[1:4], want[4:8])),
                         ("row 4", mf.post_pass(raw, mc, spec.grid.extent, size))):
            for name, (ok, err) in mcb.cells_agree(got, vnc, skip).items():
                check(ok, f"{workload}, against {ref}: {name} ({err:g}; v rtol "
                          f"{mcb.V_RTOL} atol {mcb.V_ATOL}, n and c as 3b)")
                if ref == "its plain version" and name in ("v", "n", "c"):
                    err_plain = max(err_plain, err)
        check(mcb.bits_equal(got, again), f"{workload}: two launches bit for bit")

        ct = mcb.cells_turns(spec, fr, st, size)
        med = {k: float(np.median(v)) for k, v in ct["graph_ms"].items()}
        for name, v in ct["graph_ms"].items():
            print(f"  {name} in {len(v)} turns (ms in a graph of {mcb.GRAPH_LAUNCHES}): median "
                  f"{med[name]:.5f}, min-max {min(v):.5f}-{max(v):.5f}: "
                  + ", ".join(f"{t:.5f}" for t in v))
        plain_ms = device_ms(lambda: mf.mc_field_cells_plain(*args), 1)
        bound_ms, bound_by = bound(*mcb.work("cells", fr.index, mc, cen["pairs"], cen["hits"]))
        rate = cen["pairs"] / med["cells"] / 1e6
        print(f"  mc_field_cells: kernel {med['cells']:.5f} ms ({rate:.3f} G node-candidate "
              f"pairs/s), row 4's mc_field {med['mc_field']:.5f} ms "
              f"({med['mc_field'] / med['cells']:.2f}x), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms by {bound_by}")
        print(f"  McField call {med['call']:.5f} ms in a graph, host {ct['host_ms']['call']:.4f} "
              f"ms a call; row 4's call (field_by_pieces) {med['pieces']:.5f} ms, host "
              f"{ct['host_ms']['pieces']:.4f} ms a call")
        # no single PyTorch call sums the kernel weights of the particles
        # near each lattice node
        report = dict(max_abs_err=err_plain, ms=med["cells"], plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return report


def phase_micro():
    """3h: the pair-chunk and loop probes (csrc/micro_chunk.cu,
    csrc/micro_loop.cu): the SASS of every instantiation (cuobjdump), each
    kernel against its plain version on the card at fewer trips on the
    tools' inputs and seeded ones (uncounted), then one reading of each
    kernel with the card filled through `MicroChunk` / `MicroLoop` (the
    launches counted for these kernels).  Returns (report, launches)."""
    print("== 3h. pair-chunk and loop probes (csrc/micro_chunk.cu, csrc/micro_loop.cu) against "
          "their plain PyTorch versions")
    from pbf_sph_tpu_torch.ops import cuda_build
    from pbf_sph_tpu_torch.tools import anchor_rate as ar
    from pbf_sph_tpu_torch.tools import micro_chunk as mch
    from pbf_sph_tpu_torch.tools import micro_loop as ml

    funcs = ar.sass_functions(cuda_build.library_path())
    sass_c, sass_l = mch.check_funcs(funcs), ml.check_funcs(funcs)
    for name, r in {**sass_c, **sass_l}.items():
        check(r["ok"], f"SASS {name}: " + ", ".join(
            f"{k} {v}" for k, v in r.items() if k not in ("ok", "opcodes", "fp32")))
    device = torch.device("cuda", torch.cuda.current_device())
    names = mch.KERNELS + ml.KERNELS
    errs = dict.fromkeys(names, 0.0)
    for label, (err, ok) in mch.card_parity(device).items():
        check(ok, f"{label}: max abs err {err:.3e} (chunk sums rtol {mch.RTOL}, atol "
                  f"{mch.ATOL}; fma rtol 1e-6)")
        name = "chunk_fma" if label.startswith("fma") else f"chunk_{label.split()[0]}"
        errs[name] = max(errs[name], err)
    for label, (err, ok) in ml.card_parity(device).items():
        check(ok, f"{label}: max abs err {err:.3e} (exact; rsqrt rtol {ml.RTOL_RSQRT})")
        name = ml.BODIES[label.split()[0]].kernel
        errs[name] = max(errs[name], err)

    chunk, loop = mch.MicroChunk(), ml.MicroLoop()
    inputs, xs = mch.tool_inputs(device), ml.tool_inputs(device)
    fill = {"chunk_old": mch.fill_blocks(device, "bench", "old", 1),
            "chunk_new": mch.fill_blocks(device, "bench", "new", 1),
            "chunk_fma": mch.fill_blocks(device, "fma", interleave=8)}
    # the loop body that stands in the kernels line for each loop kernel
    line_body = {"loop_fma": "b16", "loop_chain": "c16", "loop_op": "e_rsqrt"}
    for name, label in line_body.items():
        fill[name] = ml.fill_blocks(device, name, ml.BODIES[label].variant)
    with ar.ClockSampler(device) as clock:
        readings = {
            "chunk_old": mch.read_chunk(chunk, "old", 1, fill["chunk_old"], inputs, 5),
            "chunk_new": mch.read_chunk(chunk, "new", 1, fill["chunk_new"], inputs, 5),
            "chunk_fma": mch.read_fma(chunk, 8, fill["chunk_fma"], inputs, 5),
            **{name: ml.read_body(loop, label, fill[name], xs, 5)
               for name, label in line_body.items()},
        }
    torch.cuda.synchronize()
    launches = {**chunk.launches, **loop.launches}
    mhz = mch.sm_clock_mhz(clock.summary(), device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"  SM clock beside the readings (nvidia-smi, MHz): {clock.summary()}")
    s, rows, x = inputs
    # name: (plain version at the reading's larger size, fp32 and MUFU
    # instruction lanes of that launch, its bytes)
    work = {}
    for body in mch.BODIES:
        name, nb = f"chunk_{body}", fill[f"chunk_{body}"]
        slots = mch.CHUNKS * nb * mch.CTA
        r = sass_c[f"{body} x1"]
        work[name] = (lambda body=body: mch.chunk_plain(s, rows, body, 1, mch.CHUNKS),
                      slots * r["fp32_per_pair"], slots * r["mufu_per_pair"],
                      nbytes(s, rows) + 4 * nb * mch.CTA)
    nb = fill["chunk_fma"]
    work["chunk_fma"] = (lambda: mch.fma_plain(x, 8, mch.FMA_ITERS),
                         mch.FMA_ITERS * 8 * nb * mch.CTA, 0.0, nbytes(x) + 4 * nb * mch.CTA)
    for name, label in line_body.items():
        b, nb = ml.BODIES[label], fill[name]
        fp32, mufu = ml.fp32_mufu_per_trip(sass_l, label)
        threads = nb * ml.CTA
        work[name] = (lambda label=label, b=b: ml.run_plain(label, xs[b.tile], b.trips),
                      b.trips * fp32 * threads, b.trips * mufu * threads,
                      nbytes(xs[b.tile]) + 4 * threads)
    report = {}
    for name, (plain, fp32_lanes, mufu_lanes, io_bytes) in work.items():
        r = readings[name]
        plain_ms = device_ms(plain, 1, warm=False)
        bound_ms, bound_by = mch.issue_bound_ms(fp32_lanes, mufu_lanes, io_bytes, mhz, sms)
        rate = (f"{r['pair_slots_per_s'] / 1e9:.1f} G pair-slots/s" if "pair_slots_per_s" in r
                else f"{r['ffma_per_s'] / 1e12:.3f} T FFMA/s" if "ffma_per_s" in r
                else f"{r['ns_per_op']:.4f} ns an op, {r['lane_ops_per_s'] / 1e12:.3f} T "
                     f"lane-ops/s")
        print(f"  {name}: kernel {r['ms'][1]:.4f} ms at {r['nblocks']} CTAs ({rate}), plain "
              f"{plain_ms:.4f} ms (one copy), bound {bound_ms:.4f} ms by {bound_by}")
        # no single PyTorch call computes these chains
        report[name] = dict(max_abs_err=errs[name], ms=r["ms"][1], plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"  probe wrapper launches: {launches}")
    return report, launches


def phase_dense():
    """3i: the dense-λ micro-benchmark kernels (csrc/micro_dense.cu): the SASS
    of every body (cuobjdump), each body against its plain version on the
    card on the tool's inputs and seeded ones, d)/g) also against float64
    (uncounted), then one reading
    of each kernel through `MicroDense` at the JAX call's size (the launches
    counted for these kernels).  Returns (report, launches)."""
    print("== 3i. dense-λ micro-benchmark kernels (csrc/micro_dense.cu) against their plain "
          "PyTorch versions")
    from pbf_sph_tpu_torch.ops import cuda_build
    from pbf_sph_tpu_torch.tools import anchor_rate as ar
    from pbf_sph_tpu_torch.tools import micro_chunk as mch
    from pbf_sph_tpu_torch.tools import micro_dense as md

    sass = md.check_sass(cuda_build.library_path())
    for label, r in sass.items():
        check(r["ok"], f"SASS {label}: " + ", ".join(
            f"{k} {v}" for k, v in r.items() if k not in ("ok", "opcodes")))
    device = torch.device("cuda", torch.cuda.current_device())
    errs = dict.fromkeys(md.KERNELS, 0.0)
    for label, (err, ok) in md.card_parity(device).items():
        check(ok, f"{label}: max abs err {err:.3e} (rtol {md.RTOL}, atol {md.ATOL_SHARE} x "
                  f"max|value|)")
        name = md.BODIES[label.split()[0]].kernel
        errs[name] = max(errs[name], err)
    for label, (err, ok) in md.card_float64(device).items():
        check(ok, f"{label}: {err:.3e} from float64, inside the range its fp32 operands and "
                  f"sums allow")

    dense = md.MicroDense()
    x = md.tool_inputs(device=device)
    # the body that stands in the kernels line for each kernel
    line_body = {"dense_loop": "a", "dense_mxu": "d", "dense_wmxu": "g", "dense_scr": "k"}
    with ar.ClockSampler(device) as clock:
        readings = {name: md.read_body(dense, label, x, "jax", 5)
                    for name, label in line_body.items()}
    torch.cuda.synchronize()
    launches = dict(dense.launches)
    mhz = mch.sm_clock_mhz(clock.summary(), device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"  SM clock beside the readings (nvidia-smi, MHz): {clock.summary()}")
    report = {}
    for name, label in line_body.items():
        r = readings[name]
        plain_ms = device_ms(lambda label=label: md.run_plain(label, x), 1, warm=False)
        bound_ms, bound_by = md.bound_ms(md.work(label, x, md.REP), mhz, sms)
        print(f"  {name} ({label}): kernel {r['ms'][1]:.4f} ms at {r['ctas']} CTAs "
              f"({r['pairs_per_s'] / 1e9:.1f} G pairs/s, {r['ns_per_chunk']:.3f} ns a chunk), "
              f"plain {plain_ms:.4f} ms (one copy), bound {bound_ms:.4f} ms by {bound_by}")
        # no single PyTorch call computes these sums
        report[name] = dict(max_abs_err=errs[name], ms=r["ms"][1], plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"  dense wrapper launches: {launches}")
    return report, launches


def phase_roll():
    """3j: the compaction building blocks (csrc/micro_roll.cu): the SASS of
    every kernel (cuobjdump), each against its plain version on the card on
    the tools' inputs and seeded ones (uncounted), then one reading of each
    kernel through `MicroRoll` (the launches counted for these kernels).
    Returns (report, launches)."""
    print("== 3j. compaction building blocks (csrc/micro_roll.cu) against their plain "
          "PyTorch versions")
    from pbf_sph_tpu_torch.ops import cuda_build
    from pbf_sph_tpu_torch.tools import anchor_rate as ar
    from pbf_sph_tpu_torch.tools import micro_chunk as mch
    from pbf_sph_tpu_torch.tools import micro_roll as mr

    for name, r in mr.check_sass(cuda_build.library_path()).items():
        check(r["ok"], f"SASS {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()
                                                     if k != "ok"))
    device = torch.device("cuda", torch.cuda.current_device())
    errs = dict.fromkeys(mr.KERNELS, 0.0)
    for label, (err, ok) in mr.card_parity(device).items():
        tol = ("rtol 1e-5, atol 1e-5 x max|value|" if label.startswith("f ")
               else "bit for bit, NaN in place")
        check(ok, f"{label}: max abs err {err:.3e} ({tol})")
        head = label.split()
        name = ("roll_lanes" if head[0] in mr.LANES else "roll_lam" if head[0] == "f"
                else f"roll_part_blocked_{head[1]}" if head[0] in mr.PARTS and head[2] == "blocked"
                else f"roll_part_{head[1]}" if head[0] in mr.PARTS else head[0])
        errs[name] = max(errs[name], err)

    roll = mr.MicroRoll()
    xl, xp, xf, xv = (mr.lanes_inputs(device), mr.part_inputs(device), mr.lam_inputs(device),
                      mr.vpu_inputs(device))
    fill_a, fill_f = mr.fill_copies(device, "lanes", "a"), mr.fill_copies(device, "lam")
    o = xv.offset
    with ar.ClockSampler(device) as clock:
        readings = {
            "roll_lanes": mr.read_lanes(roll, "a", xl, fill_a, 5),
            "roll_part_shuffle": mr.read_part(roll, "d", "shuffle", xp, mr.REP, 5),
            "roll_part_direct": mr.read_part(roll, "d", "direct", xp, mr.REP, 5),
            "roll_part_blocked_shuffle": mr.read_part(roll, "d", "shuffle", xp, mr.REP, 5, True),
            "roll_part_blocked_direct": mr.read_part(roll, "d", "direct", xp, mr.REP, 5, True),
            "roll_lam": mr.read_lam(roll, xf, fill_f, 5),
            "vpu_rot": mr.read_launch(lambda: roll.rot(xv.tile, xv.shift)),
            "vpu_unal": mr.read_launch(lambda: roll.unal(xv.wide, o)),
            "vpu_dma": mr.read_launch(lambda: roll.dma(xv.wide, o)),
        }
    torch.cuda.synchronize()
    launches = dict(roll.launches)
    for name, r in readings.items():
        if name.startswith("roll_part_"):
            check(r["bit_equal"], f"{name} reading's output at {r['copies']} copies x "
                  f"{mr.PASSES} passes against part_plain: max abs err {r['max_abs_err']:.3e} "
                  f"(bit for bit, NaN in place)")
            errs[name] = max(errs[name], r["max_abs_err"])
    mhz = mch.sm_clock_mhz(clock.summary(), device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"  SM clock beside the readings (nvidia-smi, MHz): {clock.summary()}")
    passes = mr.PASSES[1]
    # name: (plain version at the reading's larger size, the work, the
    # library call that computes the same, or None)
    table = {
        "roll_lanes": (lambda: mr.lanes_plain("a", xl, mr.N, fill_a),
                       mr.lanes_work("a", xl, mr.N, fill_a), None),
        "roll_part_shuffle": (lambda: mr.part_plain("d", xp, mr.REP, passes),
                              mr.part_work("d", xp, mr.REP, passes), None),
        "roll_part_direct": (lambda: mr.part_plain("d", xp, mr.REP, passes),
                             mr.part_work("d", xp, mr.REP, passes), None),
        "roll_part_blocked_shuffle": (lambda: mr.part_plain("d", xp, mr.REP, passes),
                                      mr.part_work("d", xp, mr.REP, passes), None),
        "roll_part_blocked_direct": (lambda: mr.part_plain("d", xp, mr.REP, passes),
                                     mr.part_work("d", xp, mr.REP, passes), None),
        "roll_lam": (lambda: mr.lam_plain(xf, fill_f, mr.REP),
                     mr.lam_work(xf, fill_f, mr.REP), None),
        "vpu_rot": (lambda: mr.rot_plain(xv.tile, xv.shift), mr.rot_work(xv.tile, xv.shift),
                    lambda: torch.roll(xv.tile, mr.TOOL_SHIFT, 1)),
        "vpu_unal": (lambda: mr.slice_plain(xv.wide, o), mr.slice_work(),
                     lambda: xv.wide[:, o:o + mr.W].contiguous()),
        "vpu_dma": (lambda: mr.slice_plain(xv.wide, o), mr.slice_work(),
                    lambda: xv.wide[:, o:o + mr.W].contiguous()),
    }
    report = {}
    for name, (plain, work, library) in table.items():
        r = readings[name]
        plain_ms = device_ms(plain, 1, warm=False)
        bound_ms, bound_by = mr.bound_ms(work, mhz, sms)
        if name in mr.VPU:
            ms, library_ms = r["graph_ms"], mr.read_launch(library)["graph_ms"]
            what = (f"{r['graph_ms']:.5f} ms in a graph, {r['events_ms']:.5f} back to back; "
                    f"library {library_ms:.5f} ms in a graph")
        else:
            ms, library_ms = r["ms"][1], None
            rate = (f"{r['rolls_per_s'] / 1e9:.2f} G rolls/s" if "rolls_per_s" in r
                    else f"{r['parts_per_s'] / 1e9:.2f} G parts/s" if "parts_per_s" in r
                    else f"{r['pairs_per_s'] / 1e9:.1f} G pairs/s")
            what = f"{ms:.4f} ms at {r['copies']} copies ({rate})"
        print(f"  {name}: kernel {what}, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by "
              f"{bound_by}")
        if name.startswith("roll_part_blocked_"):
            orig = readings[name.replace("_blocked", "")]["ms"][1]
            variant = 3 * mr.BODY_ID[name.split("_")[-1]] + mr.LOOP_ID["d"]
            resident = cuda_build.library().micro_roll_fill(3, variant) * mr.FIELDS // sms
            print(f"    {orig / ms:.3f}x {name.replace('_blocked', '')} ({orig:.4f} ms), "
                  f"{bound_ms / ms:.3f} of the bound; {mr.REP * mr.blocked_chunks('d', xp.meta)} "
                  f"CTAs of 4 warps, {resident} warps an SM resident at most")
        # no single PyTorch call computes a)'s rolls, the part bodies or f)
        report[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    print(f"  roll wrapper launches: {launches}")
    return report, launches


def phase_vpu():
    """3k: the op streams, dots and reshape (csrc/micro_vpu.cu): the SASS of
    every kernel (cuobjdump), each against its plain version on the card on
    the tool's inputs and seeded ones (uncounted), then one reading of each
    kernel through `MicroVpu` (the launches counted for these kernels).
    Returns (report, launches)."""
    print("== 3k. op streams, dots and reshape (csrc/micro_vpu.cu) against their plain PyTorch "
          "versions")
    from pbf_sph_tpu_torch.ops import cuda_build
    from pbf_sph_tpu_torch.tools import anchor_rate as ar
    from pbf_sph_tpu_torch.tools import micro_chunk as mch
    from pbf_sph_tpu_torch.tools import micro_vpu as mv
    from pbf_sph_tpu_torch.tools.micro_mc_field import graph_ms

    sass = mv.check_sass(cuda_build.library_path())
    for name, r in sass.items():
        check(r["ok"], f"SASS {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()
                                                     if k not in ("ok", "opcodes")))
    device = torch.device("cuda", torch.cuda.current_device())
    errs = dict.fromkeys(mv.KERNELS, 0.0)
    for label, (err, ok) in mv.card_parity(device).items():
        tol = "rtol 1e-6" if label.startswith("rsqrt") else "bit for bit"
        check(ok, f"{label}: max abs err {err:.3e} ({tol})")
        name = mv.kernel_of(label)
        errs[name] = max(errs[name], err)

    vpu = mv.MicroVpu()
    x = mv.tool_inputs(device)
    n = mv.TRIPS[1]
    fill = mv.fill_blocks(device, "streams", "fma", 8)
    with ar.ClockSampler(device) as clock:
        readings = {
            "vpu_streams": mv.read_streams(vpu, x.x, "fma", 8, fill, 5),
            "vpu_dot": mv.read_dot(vpu, "dot", x, 1, 5),
            "vpu_dot2": mv.read_dot(vpu, "dot2", x, 1, 5),
            **{f"vpu_tr_{body}": mv.read_tr(vpu, body, x, 1, 5) for body in mv.TR_BODIES},
        }
        redesigns = mv.read_redesigns(vpu, x, n)
        readings["vpu_dot_spread"] = redesigns["dot_spread"]
        readings["vpu_tr_split"] = redesigns["tr_split"]
        readings["vpu_dot2_spread"] = redesigns["dot2_spread"]
        serial = mch.anchor_fma(ar.Anchor(), device, 5, serial=True)["ns_per_op"]
    torch.cuda.synchronize()
    launches = dict(vpu.launches)
    mhz = mch.sm_clock_mhz(clock.summary(), device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"  SM clock beside the readings (nvidia-smi, MHz): {clock.summary()}; serial FFMA "
          f"{serial:.4f} ns")
    # name: (plain version at the reading's larger size, the work, the
    # library call that computes the same, or None)
    table = {
        "vpu_streams": (lambda: mv.streams_plain(x.x, "fma", 8, n),
                        mv.streams_work(x.x, "fma", 8, n, fill, sass), None),
        "vpu_dot": (lambda: mv.dot_plain(x.a, x.b, n), mv.dot_work("dot", n, 1),
                    mv.library_call("dot", x, n)),
        "vpu_dot2": (lambda: mv.dot2_plain(x.a2, x.b2, n), mv.dot_work("dot2", n, 1),
                     mv.library_call("dot2", x, n)),
        **{f"vpu_tr_{body}": (lambda body=body: mv.tr_plain(x.t, body, n), mv.tr_work(n, 1),
                              mv.library_call("tr", x, n)) for body in mv.TR_BODIES},
        "vpu_dot_spread": (lambda: mv.dot_plain(x.a, x.b, n), mv.dot_work("dot", n, 1),
                           mv.library_call("dot", x, n)),
        "vpu_tr_split": (lambda: mv.tr_split_plain(x.t, n), mv.tr_work(n, 1),
                         mv.library_call("tr", x, n)),
        "vpu_dot2_spread": (lambda: mv.dot2_plain(x.a2, x.b2, n), mv.dot_work("dot2", n, 1),
                            mv.library_call("dot2", x, n)),
    }
    report = {}
    for name, (plain, work, library) in table.items():
        r = readings[name]
        ms = r["graph_ms"] if "graph_ms" in r else r["ms"][1]
        plain_ms = device_ms(plain, 1, warm=False)
        bound_ms, bound_by, what = mv.bound_ms(work, mhz, sms)
        if "chain" in work:
            what += f"; the kernel's chain {mv.chain_ms(work, serial):.6f} ms"
        library_ms = None
        if library is not None:
            got = library()
            err = float((got - plain()[0]).abs().max())
            # the redesigns' library call was read beside them, by their reader
            read = {"vpu_dot_spread": "library_dot", "vpu_tr_split": "library_tr",
                    "vpu_dot2_spread": "library_dot2"}.get(name)
            library_ms = (redesigns[read]["graph_ms"] if read
                          else graph_ms(library, launches=10))
            lib = f", library {library_ms:.5f} ms in a graph (max abs err {err:.3e} to plain)"
        else:
            lib = ""
        unit = (f"{r['lane_ops_per_s'] / 1e12:.3f} T lane-ops/s at {r['nblocks']} CTAs"
                if "lane_ops_per_s" in r else f"{r['ns_per_dot']:.1f} ns a dot, one copy"
                if "ns_per_dot" in r else f"{r['ns_per_reshape']:.3f} ns a reshape, one copy"
                if "ns_per_reshape" in r else f"one copy in a graph, {r['events_ms']:.5f} ms "
                f"by events back to back")
        if name == "vpu_tr_split":
            unit += (f"; at 0 trips {redesigns['tr_split_no_trip']['graph_ms']:.5f} ms in a "
                     f"graph, the launch with no trip")
        print(f"  {name}: kernel {ms:.5f} ms at {n} trips ({unit}), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.7f} ms by {bound_by} ({what}){lib}")
        # the streams iterate one op on each carry: no single PyTorch call
        # computes that chain
        report[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    print(f"  vpu wrapper launches: {launches}")
    return report, launches


def phase_cells():
    """3l: the main path's λ/Δp kernels (csrc/pbf_cells.cu) and their staged
    walk (csrc/cells_staged.cu): the SASS (cuobjdump), each kernel against
    its plain version and beside the per-row kernels with the wrappers' mask
    and clamp on CELL_STATES, one round of the staged walk through
    `cells_staged.StagedCells` on each state (its launches are counted
    here; the direct walk's are the main path's, phases 5 and 6), then at
    the 1M state the device ms of each
    (held_ms) beside its plain version's, its bound and the anchored ms.
    Returns (report, staged launches)."""
    print("== 3l. main-path λ/Δp kernels (csrc/pbf_cells.cu) and their staged walk "
          "(csrc/cells_staged.cu) against their plain PyTorch versions")
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import (
        TorchSolver, advect_and_sort, dyn_params_of)
    from pbf_sph_tpu_torch.ops import cuda_build
    from pbf_sph_tpu_torch.tools import anchor_rate as ar
    from pbf_sph_tpu_torch.tools import bench_cells as bc
    from pbf_sph_tpu_torch.tools import cells_staged as cs

    for name, r in bc.check_sass(cuda_build.library_path()).items():
        check(r["ok"], f"SASS {name}: " + ", ".join(
            f"{k} {v}" for k, v in r.items() if k != "ok"))
    walks = {"": False, "_staged": True}
    errs = {f"{w}_cells{s}": 0.0 for w in ("lambda", "delta") for s in walks}
    launches = {"lambda_cells_staged": 0, "delta_cells_staged": 0}
    report = {}
    for label in CELL_STATES:
        if label == "over-compressed":
            mc, cfg, xs = simple_config_with_2_cubes(*OVER_COMPRESSED)
            solver = TorchSolver(h=cfg.h, device="cuda")
            spec, state, scn = solver.prepare(cfg, Scene(), xs)
            dyn = dyn_params_of(cfg, solver.dtype, solver.device)
            fr = advect_and_sort(spec, state, dyn, scn)
        else:
            spec, dyn, fr = sort_time_state(*CELL_STATES[label])
        f = bc.Frame(spec, dyn, fr)
        stats = cs.plan_stats(f.runs)
        print(f"{label}: capacity {spec.capacity}, grid {spec.grid.dims}, {f.pairs} pairs; "
              f"staged runs {stats}")
        if label == "over-compressed":
            check(stats["over_cap"] > 0, f"{label}: {stats['over_cap']} CTAs staged in pieces")
        for suffix, staged in walks.items():
            par = bc.parity(f, staged)
            tag = f"{label}, {'staged' if staged else 'direct'} walk"
            check(par["lambda_ok"], f"{tag}: lambda max abs err {par['lambda_err']:.3e} "
                                    f"(atol 1e-6, rtol 1e-5)")
            check(par["pstar_err"] <= 1e-5 and par["finite"],
                  f"{tag}: pStar after delta max abs err {par['pstar_err']:.3e} <= 1e-5, "
                  f"finite")
            check(par["packs_kept"], f"{tag}: B's xyz is A's, A's mass kept")
            print(f"  beside the per-row kernels with the wrappers' mask and clamp: λ max diff "
                  f"{par['lambda_rows_diff']:.3e} (bit for bit {par['lambda_rows_bits']}), "
                  f"pStar max diff {par['pstar_rows_diff']:.3e} (bit for bit "
                  f"{par['pstar_rows_bits']})")
            errs[f"lambda_cells{suffix}"] = max(errs[f"lambda_cells{suffix}"], par["lambda_err"])
            errs[f"delta_cells{suffix}"] = max(errs[f"delta_cells{suffix}"], par["pstar_err"])
        wrappers = cs.StagedCells(spec.h)
        pack_b, pack_a = torch.empty_like(f.pack_a), f.pack_a.clone()
        wrappers.lambda_cells(f.index, f.pack_a, f.fluid, pack_b)
        wrappers.delta_cells(f.index, pack_b, f.fluid, *f.bounds, pack_a)
        torch.cuda.synchronize()
        for name in launches:
            launches[name] += wrappers.launches[name]
        del pack_b, pack_a
        if label != "dam1m":
            del f, fr
            torch.cuda.empty_cache()
            continue
        bounds = bc.cells_bounds(f)
        for suffix, staged in walks.items():
            b = f.lambda_cells(staged=staged)
            b_out, a_out = torch.empty_like(b), f.pack_a.clone()
            times = {
                "lambda": (lambda: f.lambda_cells(b_out, staged),
                           lambda: bc.WALKS[staged][2](f.index, f.h, f.pack_a, f.fluid, b_out)),
                "delta": (lambda: f.delta_cells(b, a_out, staged),
                          lambda: bc.WALKS[staged][3](f.index, f.h, b, f.fluid, *f.bounds,
                                                      a_out)),
            }
            for which, (kern, plain) in times.items():
                name = f"{which}_cells{suffix}"
                ms = ar.held_ms(kern, 20)
                plain_ms = device_ms(plain, 1, warm=False)
                bound_ms, bound_by = bounds[which]
                print(f"  {name}: kernel {ms:.4f} ms ({f.pairs / ms / 1e6:.3f} Gpairs/s), "
                      f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
                      f"anchored {f.pairs / bc.CELLS_CEILING[which] * 1e3:.4f} ms")
                # no single PyTorch call computes a cell-list neighbour sum
                report[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=None)
            del b, b_out, a_out
        del f, fr
        torch.cuda.empty_cache()
    for name, err in errs.items():
        report[name]["max_abs_err"] = err
    print(f"  staged-walk wrapper launches: {launches}")
    return report, launches


def phase_diffuse_cells() -> dict:
    """3m: the main path's diffuse kernels (csrc/pbf_diffuse_cells.cu)
    against their plain versions bit for bit on DIFFUSE_STATES, the 27-cell
    count against the per-row kernel's exactly, its colour sums within an
    fp32 sum's bound of the per-row kernel's and the colour beside row 3's
    path (`mix_colour` of `pbf_diffuse`, atol 1e-6), then at the 1M state the
    device ms of each (held_ms) beside its plain version's, its bound, row 3's
    path and, for the cell sums, `index_add_`.  Their launches are the main
    path's (phases 5 and 6)."""
    print("== 3m. main-path diffuse kernels (csrc/pbf_diffuse_cells.cu) against their "
          "plain PyTorch versions")
    from pbf_sph_tpu_torch.core.types import FLUID, OBSTACLE
    from pbf_sph_tpu_torch.ops import diffuse_cells as dc
    from pbf_sph_tpu_torch.ops import phases as ph
    from pbf_sph_tpu_torch.tools import anchor_rate as ar

    errs = {"diffuse_cell_sums": 0.0, "diffuse_cells": 0.0}
    report = {}
    for label, (count, iters) in DIFFUSE_STATES.items():
        spec, dyn, fr = sort_time_state(count, iters)
        idx, colour, dt = fr.index, fr.state.colour, dyn["dt"]
        ptype, alive = fr.state.ptype, fr.state.alive
        ncells = spec.grid.ncells
        if label.endswith("mixed"):
            rng = np.random.default_rng(14)
            colour = torch.from_numpy(
                rng.uniform(0.0, 1.0, (4, spec.capacity)).astype(np.float32)).to(colour.device)
            obstacle = torch.from_numpy(rng.random(spec.capacity) < 0.1).to(colour.device)
            dead = torch.from_numpy(rng.random(spec.capacity) < 0.05).to(colour.device)
            ptype = torch.where(obstacle, OBSTACLE, ptype).to(torch.int32)
            alive = alive & ~dead
        pack = dc.diffuse_cell_sums_kernel(idx, colour, ptype, alive)
        pack_p = dc.diffuse_cell_sums_plain(idx, colour, ptype, alive)
        out = dc.diffuse_cells_kernel(idx, pack, colour, ptype, alive, dt)
        out_p = dc.diffuse_cells_plain(idx, pack, colour, ptype, alive, dt)
        torch.cuda.synchronize()
        errs["diffuse_cell_sums"] = max(errs["diffuse_cell_sums"],
                                        float((pack - pack_p).abs().max()))
        errs["diffuse_cells"] = max(errs["diffuse_cells"], float((out - out_p).abs().max()))
        print(f"{label}: capacity {spec.capacity}, grid {spec.grid.dims}, members "
              f"{int(idx.table[-1])}, fullest cell {int(pack[:, 4].max())} counted rows")
        check(torch.equal(pack, pack_p), f"{label}: diffuse_cell_sums bit for bit its plain "
                                         f"version")
        check(torch.equal(out, out_p), f"{label}: diffuse_cells bit for bit its plain version")
        sums = ph.diffuse_kernel(idx, colour, ph.nonobstacle(ptype, alive))
        cell_sums = dc.neighbour_sums_plain(idx, pack)
        cnt = cell_sums[4]
        check(torch.equal(cnt, sums[4]), f"{label}: 27-cell count exact against pbf_diffuse's "
                                         f"(max {int(cnt.max())})")
        # the colour sums themselves (the mix scales an error in them by
        # dt / 750 * 1.33): two fp32 sums of the same cnt non-negative terms
        # in other orders, cnt + 27 adds at most, differ by no more than
        # (2 cnt + 27) 2^-24 of the sum
        gap = (cell_sums[:4] - sums[:4]).abs()
        limit = (2 * cnt + 27) * 2.0 ** -24 * torch.maximum(cell_sums[:4], sums[:4])
        rel = float((gap / sums[:4].clamp(min=1e-30)).max())
        check(bool((gap <= limit).all()) and bool(torch.isfinite(cell_sums).all()),
              f"{label}: 27-cell colour sums within the fp32 sum's bound of pbf_diffuse's "
              f"(max rel diff {rel:.3e})")
        diff = float((out - ph.mix_colour(colour, sums, ptype, alive, dt)).abs().max())
        mixed = int((out != colour).any(0).sum())
        check(diff <= 1e-6 and mixed > 0,
              f"{label}: colour max diff {diff:.3e} <= 1e-6 beside row 3's path, {mixed} rows "
              f"changed")
        if label != "dam1m":
            continue
        member = idx.key < ncells
        counted = (ptype != OBSTACLE) & alive & member
        gathering = (ptype == FLUID) & alive & member
        n_mixed = int((gathering & (cnt > 0.5)).sum())
        # the one PyTorch call that computes the cell sums: index_add_ of the
        # counted rows' (r, g, b, a, 1) by cell, non-members into one more row
        values = torch.where(counted[:, None], torch.cat([colour, torch.ones_like(colour[:1])]).T,
                             0.0).contiguous()
        at = torch.clamp(idx.key, max=ncells).long()
        lib = torch.zeros((ncells + 1, 5), device=colour.device).index_add_(0, at, values)
        check(torch.equal(lib[:ncells, 4], pack[:, 4]), "index_add_ gives the same counts")
        lib_ms = ar.held_ms(lambda: lib.index_add_(0, at, values), 20)
        # the pack's bytes that hold sums: 5 floats a cell (its 3 pad floats
        # only align the float4 reads)
        sum_bytes = ncells * 5 * pack.element_size()
        work = {
            "diffuse_cell_sums": (
                lambda: dc.diffuse_cell_sums_kernel(idx, colour, ptype, alive),
                lambda: dc.diffuse_cell_sums_plain(idx, colour, ptype, alive),
                nbytes(colour, ptype, alive, idx.table) + sum_bytes,
                int(counted.sum()) * CELL_SUM_FLOP, lib_ms),
            "diffuse_cells": (
                lambda: dc.diffuse_cells_kernel(idx, pack, colour, ptype, alive, dt),
                lambda: dc.diffuse_cells_plain(idx, pack, colour, ptype, alive, dt),
                sum_bytes + nbytes(idx.key, colour, ptype, alive, dt, out),
                # no single PyTorch call gathers 27 cells' sums a row and mixes
                int(gathering.sum()) * GATHER_FLOP + n_mixed * MIX_FLOP, None),
        }
        for name, (kern, plain, io_bytes, flops, library_ms) in work.items():
            ms = ar.held_ms(kern, 20)
            plain_ms = device_ms(plain, 1, warm=False)
            bound_ms, bound_by = bound(io_bytes, flops)
            lib_txt = f"index_add_ {library_ms:.4f} ms" if library_ms else "no library call"
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms by {bound_by} ({io_bytes} bytes, {flops} flop), "
                  f"{lib_txt}")
            report[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=library_ms)
        phases = ph.PbfPhases(spec.h)
        pair_ms = ar.held_ms(lambda: phases.diffuse(idx, colour, ptype, alive, dt), 20)
        rows_ms = ar.held_ms(lambda: phases.diffuse_rows(idx, colour, ptype, alive, dt), 20)
        print(f"  PbfPhases.diffuse (both kernels) {pair_ms:.4f} ms, diffuse_rows (row 3: "
              f"pbf_diffuse, its pack and mix_colour) {rows_ms:.4f} ms; {n_mixed} rows mixed")
        del lib, values, at
    for name, err in errs.items():
        report[name]["max_abs_err"] = err
    return report


def phase_parity() -> None:
    print("== 4. TorchSolver on the card against TorchSolver on the CPU")
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

    mc, cfg, xs = simple_config_with_2_cubes(700, 2, 500.0)
    ends = []
    for device in ("cuda", "cpu"):
        solver = TorchSolver(h=cfg.h, device=device)
        x = xs
        for _ in range(2):
            _, x = solver.advance(cfg, Scene(), x)
        ends.append(x.order_by_id())
    g, c = ends
    check(np.array_equal(g.pid, c.pid), f"same {len(g)} particle ids")
    for name, atol in (("position", 1e-3), ("velocity", 1e-3), ("colour", 1e-5)):
        err = float(np.abs(getattr(g, name) - getattr(c, name)).max())
        check(err <= atol, f"{name} max abs err {err:.3e} <= {atol}")


def phase_extract(lattice) -> None:
    print("== 4b. mc_extract and the surface frame, card against CPU")
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver
    from pbf_sph_tpu_torch.ops.mc import mc_extract

    spec, dyn, fr, v, n, c = lattice
    scale = torch.full((), spec.scale, device=v.device)
    args = (v, n, c, fr.min_extent, spec.surface, spec.h, scale, dyn["mc_isolevel"])
    card = mc_extract(*args)
    cpu = mc_extract(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    t = int(cpu[3])
    check(int(card[3]) == t > 0 and int(card[4]) == int(cpu[4]) == 0,
          f"mc128k lattice: {t} triangles on both, no emit overflow")
    for name, g, w in zip(("vertices", "normals", "colours"), card[:3], cpu[:3]):
        g, w = g[:, :3 * t].cpu(), w[:, :3 * t]
        err = float(torch.nan_to_num((g - w).abs(), nan=0.0).max())
        check(torch.equal(torch.isnan(g), torch.isnan(w)) and err <= 1e-4,
              f"{name} max abs err {err:.3e} <= 1e-4, NaN where the CPU has NaN")

    mc, cfg, xs = simple_config_with_2_cubes(1500, 2, 500.0)
    cfg = cfg.replace(surface=mc)
    tris = []
    for device in ("cuda", "cpu"):
        res, _ = TorchSolver(h=cfg.h, device=device).advance(cfg, Scene(), xs)
        tris.append(len(res.mesh) // 3)
    check(tris[1] > 0 and abs(tris[0] - tris[1]) <= 0.01 * tris[1],
          f"2-cube 1500 surface frame: {tris[0]} triangles on the card, {tris[1]} "
          f"on the CPU (within 1%)")


def run_path(solver, cfg, xs, warmup: int = WARMUP, frames: int = TIMED_FRAMES):
    """prepare, the growth warmup (`warmup` frames a round) and `frames`
    timed frames, with the launch counts set to 0 just before and read just
    after.  Returns (spec, state, dyn, scn, outs, frames run, launches, wall
    s, device ms)."""
    from pbf_sph_tpu_torch.bench import time_frames, warm_up
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import dyn_params_of

    solver.reset_launches()
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    print(f"{len(xs)} particles, capacity {spec.capacity}, grid {spec.grid.dims} "
          f"({spec.grid.ncells} cells)")
    t0 = time.perf_counter()
    spec, state, warm = warm_up(solver, spec, state, dyn, scn, xs, warmup)
    torch.cuda.synchronize()
    print(f"warmup: {warm} frames in {time.perf_counter() - t0:.2f} s")
    state, outs, wall, dev_ms = time_frames(solver, spec, state, dyn, scn, frames)
    launches = dict(solver.launches)
    return spec, state, dyn, scn, outs, warm + frames, launches, wall, dev_ms


def check_frames(spec, state, cfg, outs, n: int, solver) -> dict:
    """Checks shared by the main paths; returns the last frame's outputs with
    the peak occupancy."""
    from pbf_sph_tpu_torch.models.growth import growth_changes

    out = dict(outs[-1])
    out["max_occupancy"] = max(int(o["max_occupancy"]) for o in outs)
    check(all(int(o["alive_count"]) == n for o in outs), f"alive_count == {n} every frame")
    check(all(bool(o["extent_ok"]) for o in outs), "extent_ok every frame")
    check(growth_changes(spec, out) == {} and int(out["strip_overflow"]) == 0,
          f"no capacity overflow (max occupancy {out['max_occupancy']}, "
          f"cell capacity {spec.cell_capacity})")
    pos = state.position[:, state.alive]
    lo = torch.tensor(cfg.min_bound, device=solver.device)[:, None] - 1e-2
    hi = torch.tensor(cfg.max_bound, device=solver.device)[:, None] + 1e-2
    check(bool(torch.isfinite(pos).all()) and bool(torch.isfinite(state.velocity).all()),
          "positions and velocities finite")
    check(bool(((pos >= lo) & (pos <= hi)).all()), "positions inside the bounds")
    return out


def phase_main_path() -> dict:
    print("== 5. main path: dam_break(1_000_000, 6) through TorchSolver(device='cuda')")
    from pbf_sph_tpu_torch.bench import phase_breakdown
    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

    mc, cfg, xs = dam_break(1_000_000, solver_iter=6)
    n = len(xs)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, dyn, scn, outs, frames, launches, wall, dev_ms = run_path(solver, cfg, xs)
    check_frames(spec, state, cfg, outs, n, solver)
    want = {"diffuse": 0, "diffuse_cell_sums": frames, "diffuse_cells": frames, "lambda": 0,
            "delta": 0, "lambda_cells": 6 * frames, "delta_cells": 6 * frames,
            "mc_field_cells": 0, "mc_field": 0}
    check(launches == want, f"kernel launches {launches} == 14 x {frames} frames")

    ms = 1000 * wall / TIMED_FRAMES
    print(f"{card_line()}: {ms:.3f} ms/step (device events {dev_ms:.3f} ms/step), "
          f"{n * TIMED_FRAMES / wall:.4e} particle-steps/s over {TIMED_FRAMES} frames")
    _, stages = phase_breakdown(solver, spec, state, dyn, scn, 5)
    print("device ms per frame by stage (CUDA events, 5 frames): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()))
    return launches, ms


def check_surface(spec, state, cfg, outs, n: int, solver) -> dict:
    """`check_frames` and the surface checks of a surface path; returns the
    last frame's outputs."""
    sur = spec.surface
    print(f"surface: res {sur.resolution}, lattice {sur.sample}, tri_capacity "
          f"{sur.tri_capacity}, cube_cap {sur.cube_cap}")
    out = check_frames(spec, state, cfg, outs, n, solver)
    check(all(int(o["mc_emit_overflow"]) == 0 and int(o["mc_strip_overflow"]) == 0
              for o in outs), "no emit overflow every frame")
    tris = [int(o["tri_count"]) for o in outs]
    check(all(0 < t <= sur.tri_capacity for t in tris),
          f"0 < tri_count <= {sur.tri_capacity} every frame ({min(tris)}..{max(tris)})")
    t3 = 3 * int(out["tri_count"])
    vs, ns = out["mesh_vs"][:, :t3], out["mesh_ns"][:, :t3]
    reach = cfg.h * spec.scale
    lo = torch.tensor(cfg.min_bound, device=solver.device)[:, None] - reach
    hi = torch.tensor(cfg.max_bound, device=solver.device)[:, None] + reach
    check(bool(torch.isfinite(vs).all()) and bool(((vs >= lo) & (vs <= hi)).all()),
          f"{t3} vertices finite and within h*scale = {reach:.3f} of the bounds "
          f"(min {vs.min(1).values.tolist()}, max {vs.max(1).values.tolist()})")
    return out


def phase_surface_path() -> dict:
    print("== 6. surface path: mc128k through TorchSolver(device='cuda')")
    from pbf_sph_tpu_torch.bench import phase_breakdown
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

    mc, cfg, xs = WORKLOADS["mc128k"]()
    n = len(xs)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, dyn, scn, outs, frames, launches, wall, dev_ms = run_path(solver, cfg, xs)
    out = check_surface(spec, state, cfg, outs, n, solver)
    want = {"diffuse": 0, "diffuse_cell_sums": frames, "diffuse_cells": frames, "lambda": 0,
            "delta": 0, "lambda_cells": 3 * frames, "delta_cells": 3 * frames,
            "mc_field_cells": frames, "mc_field": 0}
    check(launches == want, f"kernel launches {launches} == 9 x {frames} frames")

    ms = 1000 * wall / TIMED_FRAMES
    ns = out["mesh_ns"][:, :3 * int(out["tri_count"])]
    nan_share = float(torch.isnan(ns).any(0).float().mean())
    print(f"{card_line()}: {ms:.3f} ms/step (device events {dev_ms:.3f} ms/step), "
          f"{n * TIMED_FRAMES / wall:.4e} particle-steps/s over {TIMED_FRAMES} frames; "
          f"{int(out['tri_count'])} triangles, {nan_share:.4f} of the vertices with "
          f"NaN normals")
    _, stages = phase_breakdown(solver, spec, state, dyn, scn, 5)
    print("device ms per frame by stage (CUDA events, 5 frames): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()))
    check("mc field" in stages and "mc extract" in stages, "both MC stages timed")
    return launches


# phase 7c/7d: the gather backend's growth warmup (frames a round) and timed
# frames; its frame takes seconds at dam1m
GATHER_WARMUP = 2
GATHER_FRAMES = 3


def check_no_launches(solver, what: str) -> None:
    """The solver launched no port kernel since its counts were last set to
    0 (by `run_path`, or when it was built)."""
    check(all(v == 0 for v in solver.launches.values()),
          f"{what}: no port kernel launched {solver.launches}")


def phase_gather_parity() -> None:
    print("== 7a. the gather backend on the card against the gather backend on the CPU")
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

    mc, cfg, xs = simple_config_with_2_cubes(700, 2, 500.0)
    cfg = cfg.replace(surface=mc)
    for dtype, atols in (("float32", (1e-3, 1e-3, 1e-5)), ("float64", (1e-7, 1e-7, 1e-7))):
        ends, tris = [], []
        for device in ("cuda", "cpu"):
            solver = TorchSolver(h=cfg.h, dtype=dtype, gather=True, device=device)
            x = xs
            for _ in range(2):
                res, x = solver.advance(cfg, Scene(), x)
            check_no_launches(solver, f"{dtype} on {device}")
            ends.append(x.order_by_id())
            tris.append(len(res.mesh) // 3)
        g, c = ends
        check(np.array_equal(g.pid, c.pid) and g.position.dtype == np.dtype(dtype),
              f"{dtype}: same {len(g)} particle ids")
        for name, atol in zip(("position", "velocity", "colour"), atols):
            err = float(np.abs(getattr(g, name) - getattr(c, name)).max())
            check(err <= atol, f"{dtype} {name} max abs err {err:.3e} <= {atol}")
        check(tris[1] > 0 and abs(tris[0] - tris[1]) <= 0.01 * tris[1],
              f"{dtype}: {tris[0]} triangles on the card, {tris[1]} on the CPU (within 1%)")


def phase_gather_vs_kernels() -> None:
    print("== 7b. the gather backend against the kernel backend on the card, one mc128k frame")
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

    mc, cfg, xs = WORKLOADS["mc128k"]()
    ends, tris = [], []
    for gather in (True, False):
        solver = TorchSolver(h=cfg.h, gather=gather, device="cuda")
        res, x = solver.advance(cfg, Scene(), xs)
        ends.append(x.order_by_id())
        tris.append(len(res.mesh) // 3)
    g, k = ends
    check(len(g) == len(k) == len(xs) and np.array_equal(g.pid, k.pid),
          f"{len(g)} particles on both, the same ids")
    for name, atol in (("position", 1e-3), ("velocity", 1e-3), ("colour", 1e-5)):
        err = float(np.abs(getattr(g, name) - getattr(k, name)).max())
        check(err <= atol, f"{name} max abs err {err:.3e} <= {atol}")
    check(tris[1] > 0 and abs(tris[0] - tris[1]) <= 0.01 * tris[1],
          f"{tris[0]} triangles through gather, {tris[1]} through the kernels (within 1%)")


def gather_path(workload: str, dtype: str, breakdown_frames: int):
    """One gather path through `run_path`: the checks of its main path, 0
    launches, ms/step, the peak device memory and the stage times.
    Returns the last frame's outputs, the spec and the solver."""
    from pbf_sph_tpu_torch.bench import phase_breakdown
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

    mc, cfg, xs = WORKLOADS[workload]()
    n = len(xs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solver = TorchSolver(h=cfg.h, dtype=dtype, gather=True, device="cuda")
    spec, state, dyn, scn, outs, frames, _, wall, dev_ms = run_path(
        solver, cfg, xs, GATHER_WARMUP, GATHER_FRAMES)
    if spec.surface is None:
        out = check_frames(spec, state, cfg, outs, n, solver)
    else:
        out = check_surface(spec, state, cfg, outs, n, solver)
    check_no_launches(solver, f"{workload} {dtype} through gather over {frames} frames")
    check(state.position.dtype == getattr(torch, dtype), f"state in {dtype}")
    ms = 1000 * wall / GATHER_FRAMES
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{card_line()}: {workload} gather {dtype}: {ms:.3f} ms/step (device events "
          f"{dev_ms:.3f} ms/step) over {GATHER_FRAMES} frames, K {spec.cell_capacity}, "
          f"capacity {spec.capacity}, peak device memory {peak:.3f} GiB")
    _, stages = phase_breakdown(solver, spec, state, dyn, scn, breakdown_frames)
    print(f"device ms per frame by stage (CUDA events, {breakdown_frames} frames): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    return out, spec


def phase_gather_paths() -> None:
    print("== 7c. dam1m through the gather backend, float32")
    gather_path("dam1m", "float32", 1)
    print("== 7d. mc128k through the gather backend, float64, with its surface")
    _, spec = gather_path("mc128k", "float64", 2)
    check(spec.surface is not None, "the surface was extracted")


def run_cli(argv):
    """`cli.main(argv)` with its standard output captured (and printed);
    returns (exit code, {stats label: value}, output)."""
    import contextlib
    import io

    from pbf_sph_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    print(text.rstrip())
    stats = {line.split(":")[0].strip(): line.split(":", 1)[1].strip()
             for line in text.splitlines() if " : " in line}
    return rc, stats, text


def phase_cli() -> None:
    print("== 7e. the CLI on bench20k through both backends")
    import tempfile
    from pathlib import Path

    from pbf_sph_tpu_torch import cli
    from pbf_sph_tpu_torch.core.configs import WORKLOADS

    n = len(WORKLOADS["bench20k"]()[2])
    made = []
    make = cli.make_solver

    def make_and_keep(*args, **kwargs):  # the CLI's solver, to read its launches
        made.append(make(*args, **kwargs))
        return made[-1]

    cli.make_solver = make_and_keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for impl, extra, fp64 in (("torch", [], False), ("gather", ["--fp64"], True)):
                argv = ["--impl", impl, *extra, "--warmup", "2", "--iter", "3",
                        "--output", f"{tmp}/out_{{impl}}_{{type}}_{{iter}}"]
                rc, stats, text = run_cli(argv)
                check(rc == 0 and "Results flushed." in text, f"cli {' '.join(argv)}: rc 0")
                count, verts = int(stats["Final Particle count"]), int(stats["Final Vertex count"])
                check(count == n and verts > 0,
                      f"{impl}: {count} particles of {n}, {verts} vertices")
                out = Path(tmp) / cli.rendered_output_name("out_{impl}_{type}_{iter}", impl,
                                                           fp64, 3)
                ply = (out / "cloud.ply").read_text().splitlines()
                obj = (out / "mesh.obj").read_text().splitlines()
                check(f"element vertex {n}" in ply and len(ply) - ply.index("end_header") - 1 == n
                      and sum(1 for line in obj if line.startswith("v ")) == verts,
                      f"{impl}: {out.name}/cloud.ply holds {n} points, mesh.obj {verts} vertices")
                solver = made[-1]
                launched = sum(solver.launches.values())
                check((launched > 0) == (impl == "torch"),
                      f"{impl}: {launched} kernel launches {solver.launches}")
                print(f"{card_line()}: cli bench20k --impl {impl}{' --fp64' if fp64 else ''}: "
                      f"frame-time mean {stats['Frame-time mean']}, "
                      f"min {stats['Frame-time min']}, max {stats['Frame-time max']}")
    finally:
        cli.make_solver = make
    rc, _, _ = run_cli(["--impl", "torch", "--fp64"])
    check(rc == 1, "cli --impl torch --fp64 returns 1")


# phase 8: the visualise loop.  8a's scheduled changes: the λ/Δp launches an
# attempt drop to 1 each, the MC lattice grows, the surface stage goes and
# comes back with McParams()'s defaults, a dynamic force changes
VIS_SETS = ("6:iteration=1", "10:mc_resolution=1.0", "14:surface=0", "18:surface=1",
            "20:force=0,12,0")
# kernels of the per-row path and row 4, which no visualise frame launches
VIS_ZERO = ("diffuse", "lambda", "delta", "mc_field")
BACKGROUND = (20, 22, 28)  # render.render_mesh's bg as save_png writes it


class VisRun:
    """`visualise.main(argv)` in-process with its module-level names wrapped:
    the solver it builds (kept), each frame's config, launches by kernel (the
    counts set to 0 just before its `advance` and read just after) and,
    with `keep`, (result, xs); the host-clock seconds of each `advance` and
    of each PLY, OBJ and PNG written, by file name.  `visualise.py` itself
    has no timing code."""

    def __init__(self, argv, keep: bool = False):
        import contextlib
        import io

        from pbf_sph_tpu_torch import visualise

        self.solvers, self.frames, self.advance_s, self.write_s = [], [], [], {}
        names = ("make_solver", "save_ply_points", "save_obj_mesh", "render_frame")
        real = {name: getattr(visualise, name) for name in names}
        run = self

        class Counted:
            def __init__(self, solver):
                self.solver = solver

            def advance(self, config, scene, xs):
                self.solver.reset_launches()
                t0 = time.perf_counter()
                result, xs = self.solver.advance(config, scene, xs)
                run.advance_s.append(time.perf_counter() - t0)
                run.frames.append(dict(config=config, launches=dict(self.solver.launches),
                                       n=len(xs), kept=(result, xs) if keep else None))
                return result, xs

        def make_solver(*args, **kwargs):
            run.solvers.append(real["make_solver"](*args, **kwargs))
            return Counted(run.solvers[-1])

        def timed(name):
            def write(path, *args, **kwargs):
                t0 = time.perf_counter()
                real[name](path, *args, **kwargs)
                run.write_s[path.name] = time.perf_counter() - t0
            return write

        buf = io.StringIO()
        try:
            visualise.make_solver = make_solver
            for name in names[1:]:
                setattr(visualise, name, timed(name))
            with contextlib.redirect_stdout(buf):
                self.rc = visualise.main(argv)
        finally:
            for name in names:
                setattr(visualise, name, real[name])
        self.text = buf.getvalue()
        self.solver = self.solvers[-1]

    def launch_totals(self) -> dict:
        total = {}
        for f in self.frames:
            for k, v in f["launches"].items():
                total[k] = total.get(k, 0) + v
        return total


def check_vis_run(run: VisRun, out, frames, every: int, ckpt_every: int, render: bool,
                  turntable: int, n: int, surface_on, frame0: int = 0) -> None:
    """Checks of one card run of the loop: rc 0 and the frame lines, the
    files written exactly the expected set, each PLY the particle count,
    each OBJ > 0 vertices finite and within h*scale of its frame's bounds,
    each PNG 640x480 with covered pixels, the solver on cuda (kernel
    backend), and each frame's launches a whole number of attempts of its
    set: iteration lambda_cells and delta_cells, one diffuse_cell_sums,
    diffuse_cells and (with the surface) mc_field_cells an attempt, and 0 of
    the per-row kernels and row 4."""
    from PIL import Image

    check(run.rc == 0 and len(run.frames) == frames and all(
        f"frame {frame0 + i}: particles={n} " in run.text for i in range(frames)),
        f"rc 0, frames {frame0}..{frame0 + frames - 1} with {n} particles each")
    solver = run.solver
    check(solver.device.type == "cuda" and not solver.gather,
          f"the solver runs the kernel backend on {solver.device}")
    want = set()
    for f in range(frame0, frame0 + frames):
        if f % every == 0:
            want.add(f"cloud_{f:05d}.ply")
            if surface_on(f):
                want.add(f"mesh_{f:05d}.obj")
            if render:
                want.add(f"frame_{f:05d}.png")
        if ckpt_every and f % ckpt_every == 0:
            want.add(f"ckpt_{f:05d}.npz")
    want |= {f"turntable_{k:02d}.png" for k in range(turntable)}
    got = {p.name for p in out.iterdir()}
    check(got == want, f"the files written are the {len(want)} expected "
          f"({len([w for w in want if w.endswith('.obj')])} OBJ, "
          f"{len([w for w in want if w.endswith('.png')])} PNG)")

    plys = sorted(out.glob("cloud_*.ply"))
    ok = True
    for p in plys:
        lines = p.read_text().splitlines()
        ok &= f"element vertex {n}" in lines and len(lines) - lines.index("end_header") - 1 == n
    check(ok, f"each of {len(plys)} PLY holds {n} points")
    objs, reaches = {}, set()
    for p in sorted(out.glob("mesh_*.obj")):
        cfg = run.frames[int(p.stem.split("_")[1]) - frame0]["config"]
        vs = np.array([[float(x) for x in line.split()[1:4]]
                       for line in p.read_text().splitlines() if line.startswith("v ")])
        reach = cfg.h * cfg.scale
        lo, hi = np.asarray(cfg.min_bound) - reach, np.asarray(cfg.max_bound) + reach
        ok = len(vs) > 0 and np.isfinite(vs).all() and ((vs >= lo) & (vs <= hi)).all()
        objs[p.stem[5:]] = len(vs) if ok else f"FAILED ({len(vs)})"
        reaches.add(round(reach, 3))
    check(all(isinstance(v, int) for v in objs.values()),
          f"each OBJ > 0 vertices, finite, within h*scale = {sorted(reaches)} of its "
          f"frame's bounds: vertices by frame {objs}")
    pngs = {}
    for p in sorted(out.glob("*.png")):
        img = np.asarray(Image.open(p).convert("RGB"))
        covered = int((img != np.asarray(BACKGROUND, np.uint8)).any(-1).sum())
        pngs[p.stem] = covered if img.shape == (480, 640, 3) and covered >= 100 else \
            f"FAILED {img.shape} {covered}"
    check(all(isinstance(v, int) for v in pngs.values()),
          f"each PNG 640x480 with covered pixels: {pngs}")

    attempts = []
    for f in run.frames:
        c, launches = f["config"], f["launches"]
        k = launches.get("diffuse_cells", 0)
        expect = dict.fromkeys(VIS_ZERO, 0)
        expect.update(diffuse_cell_sums=k, diffuse_cells=k, lambda_cells=c.iteration * k,
                      delta_cells=c.iteration * k,
                      mc_field_cells=k if c.surface is not None else 0)
        attempts.append((k, sum(launches.values()) // max(k, 1))
                        if k >= 1 and launches == expect else (0, launches))
    check(all(a[0] >= 1 for a in attempts),
          "each frame's launches a whole number of attempts of its set, 0 of "
          f"{', '.join(VIS_ZERO)}: (attempts, launches an attempt) by frame {attempts}")


def vis_split(run: VisRun, frames) -> str:
    """Host-clock means over `frames` of advance and each file written."""
    parts = [f"advance {1e3 * np.mean([run.advance_s[f] for f in frames]):.3f}"]
    for label, name in (("PLY write", "cloud_{:05d}.ply"), ("OBJ write", "mesh_{:05d}.obj"),
                        ("render", "frame_{:05d}.png")):
        ts = [run.write_s[name.format(f)] for f in frames if name.format(f) in run.write_s]
        parts.append(f"{label} {1e3 * np.mean(ts):.3f}" if ts else f"{label} not run")
    return ", ".join(parts) + " ms a frame"


def phase_visualise() -> dict:
    """Phase 8; returns the launches by kernel summed over its card runs."""
    import tempfile
    from pathlib import Path

    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.core.types import McParams

    totals = {}

    def add(run):
        for k, v in run.launch_totals().items():
            totals[k] = totals.get(k, 0) + v

    print("== 8a. the visualise loop: the GUI workload with scheduled changes")
    n = len(simple_config_with_2_cubes(20_000, 3, 500.0)[2])
    sets = [a for s in VIS_SETS for a in ("--set", s)]
    base = ["--particles", "20000", "--solver-iter", "3", "--every", "4", "--render",
            "--checkpoint-every", "8", "--turntable", "2", *sets]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "gui"
        run = VisRun([*base, "--frames", "24", "--out", str(out)])
        print(run.text.rstrip())
        check_vis_run(run, out, 24, 4, 8, True, 2, n, lambda f: not 14 <= f < 18)
        add(run)
        cfgs = [f["config"] for f in run.frames]
        check([c.iteration for c in cfgs] == [3] * 6 + [1] * 18
              and [c.surface.resolution if c.surface else None for c in cfgs]
              == [2.0] * 10 + [1.0] * 4 + [None] * 4 + [2.0] * 6
              and cfgs[18].surface == McParams()
              and all(c.constant_force == ((0.0, 12.0, 0.0) if i >= 20 else (0.0, 9.8, 0.0))
                      for i, c in enumerate(cfgs)),
              "the scheduled changes took effect at their frames (iteration 3 -> 1 at 6, "
              "res 2.0 -> 1.0 at 10, surface off 14-17, back at McParams() at 18, force at 20)")
        lattices = sorted({s.surface.sample for s in run.solver._steps if s.surface})
        print(f"one TorchSolver, {len(run.solver._steps)} step specs, MC lattices {lattices}")
        check("turntable: 2 views" in run.text, "2 turntable views")
        print(f"{card_line()}: 8a host clock, frames 2-23: {vis_split(run, range(2, 24))}")

        resumed = Path(tmp) / "resumed"
        run2 = VisRun([*base, "--resume", str(out / "ckpt_00016.npz"), "--frames", "2",
                       "--out", str(resumed)])
        print(run2.text.rstrip())
        check(f"resumed {n} particles after frame 16" in run2.text, "resumed after frame 16")
        check_vis_run(run2, resumed, 2, 4, 8, True, 2, n, lambda f: True, frame0=17)
        add(run2)

        small = [*base, "--particles", "700", "--frames", "2"]
        card = VisRun([*small, "--out", str(Path(tmp) / "card")], keep=True)
        cpu = VisRun([*small, "--devices", "cpu", "--out", str(Path(tmp) / "cpu")], keep=True)
        check(card.solver.device.type == "cuda" and cpu.solver.device.type == "cpu"
              and card.rc == cpu.rc == 0, "the 700-particle copy on the card and with "
              "--devices cpu")
        add(card)
        for i in range(2):
            (rg, g), (rc_, c) = card.frames[i]["kept"], cpu.frames[i]["kept"]
            g, c = g.order_by_id(), c.order_by_id()
            check(np.array_equal(g.pid, c.pid), f"frame {i}: same {len(g)} particle ids")
            for name, atol in (("position", 1e-3), ("velocity", 1e-3), ("colour", 1e-5)):
                err = float(np.abs(getattr(g, name) - getattr(c, name)).max())
                check(err <= atol, f"frame {i}: {name} max abs err {err:.3e} <= {atol}")
            t_g, t_c = len(rg.mesh) // 3, len(rc_.mesh) // 3
            check(t_c > 0 and abs(t_g - t_c) <= 0.01 * t_c,
                  f"frame {i}: {t_g} triangles on the card, {t_c} on the CPU (within 1%)")

    print("== 8b. the visualise loop: the rendering user's 128k dam break, mc128k's lattice")
    n = len(dam_break(128_000, 3)[2])
    base = ["--workload", "dam", "--particles", "128000", "--solver-iter", "3",
            "--mc-resolution", "1.0", "--frames", "12"]
    for render in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "dam"
            run = VisRun([*base, *(["--render"] if render else []), "--out", str(out)])
            print("\n".join(run.text.splitlines()[:2] + ["..."] + run.text.splitlines()[-1:]))
            check_vis_run(run, out, 12, 1, 0, render, 0, n, lambda f: True)
            add(run)
            specs = run.solver._steps
            check(all(s.surface.resolution == 1.0 for s in specs),
                  f"{len(specs)} step specs, all at res 1.0: MC lattices "
                  f"{sorted({s.surface.sample for s in specs})}")
            print(f"{card_line()}: 8b{' --render' if render else ''} host clock, means "
                  f"over frames 2-11: {vis_split(run, range(2, 12))}")
    return totals


# phase 9: the slab engine.  Phase 4's tolerances (card against CPU), the
# JAX package's sharded-against-single tolerances (tests/test_sharded.py:
# 63-77), the per-row kernels that no slab frame launches, and 9b's frames
SLAB_TOLS = (("position", 1e-3), ("velocity", 1e-3), ("colour", 1e-5))
SLAB_SINGLE_TOLS = (("position", 0.1), ("velocity", 0.1), ("colour", 2e-3))
SLAB_ZERO = ("diffuse", "lambda", "delta")
SLAB_WARMUP = 2
SLAB_FRAMES = 4
SLAB_PROFILED = 2


def slab_probe_phases(h):
    """A `PbfPhases` that keeps the inputs of its first `diffuse` and `solve`
    (the rank's local index at the shapes of the slab frame), so that each
    kernel can be held against its plain version on them afterwards."""
    from pbf_sph_tpu_torch.ops.phases import PbfPhases

    class SlabProbe(PbfPhases):
        kept_diffuse = kept_solve = None

        def diffuse(self, index, colour, ptype, alive, dt):
            if self.kept_diffuse is None:
                self.kept_diffuse = (index, colour.clone(), ptype, alive, dt)
            return super().diffuse(index, colour, ptype, alive, dt)

        def solve(self, index, pstar, mass, ptype, alive, iteration, scale, min_bound,
                  max_bound, mark=None, refresh_lam=None, refresh_pstar=None):
            if self.kept_solve is None:
                self.kept_solve = (index, pstar.clone(), mass, ptype, alive, scale,
                                   min_bound, max_bound)
            return super().solve(index, pstar, mass, ptype, alive, iteration, scale,
                                 min_bound, max_bound, mark, refresh_lam, refresh_pstar)

    return SlabProbe(h)


def slab_run(spec, cfg, xs, device, frames: int, motion: bool = False, probe: bool = False,
             timed_from=None, start=None, frame0: int = 0, bounds0=None):
    """`frames` frames of the slab engine (a `ShardSpec`) or the tile engine
    (a `Shard2DSpec`) from `xs` (or from `start`, the ranks of an earlier
    run: their states and bounds) on ThreadComm ranks on `device`; with
    `motion` the sloshing bounds of frames frame0...  `bounds0` replaces the
    spec's first bounds (a rebalancing run).  The launch counts are set to 0
    just before the first frame and read just after the last.  With
    `timed_from`, rank 0 reads the host clock around frames timed_from..
    (each end after every rank has enqueued its frames and the card has
    finished them).  Returns the ranks' dicts in rank order."""
    from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z
    from pbf_sph_tpu_torch.models.torch_solver import dyn_params_of
    from pbf_sph_tpu_torch.parallel import sharded, sharded2d
    from pbf_sph_tpu_torch.parallel.comm import run_ranks

    tiles = isinstance(spec, sharded2d.Shard2DSpec)
    n_ranks = spec.nx * spec.ny if tiles else spec.n_dev
    if start is None:
        if bounds0 is None:
            bounds0 = spec.initial_bounds() if tiles else spec.initial_bounds(xs)
        whole = (sharded2d.distribute_particles_2d(xs, spec, bounds=bounds0) if tiles
                 else sharded.distribute_particles(xs, spec, bounds=bounds0))

    def settle(comm):
        comm.all_reduce_sum(torch.zeros(1, device=device))  # every rank enqueued
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def rank(comm):
        if start is None:
            state, b = sharded.local_state(whole, comm.rank, spec, device), bounds0
        else:
            state, b = start[comm.rank]["state"], start[comm.rank]["last_bounds"]
        step = (sharded2d.build_sharded2d_step if tiles else sharded.build_sharded_step)(
            spec, comm)
        if probe:
            step.phases = slab_probe_phases(spec.h)
        stats, bounds, t0 = [], [], None
        step.reset_launches()
        for f in range(frames):
            if f == timed_from:
                t0 = settle(comm)
            g = frame0 + f
            dyn = dyn_params_of(apply_motion_sin_x_cos_z(cfg, g) if motion else cfg,
                                np.float32, device)
            if spec.rebalance:
                state, s, b = step(state, dyn, bounds=b)
                bounds.append(tuple(v.cpu().numpy() for v in b) if tiles else b.cpu().numpy())
            else:
                state, s = step(state, dyn)
            stats.append(s)
        wall = settle(comm) - t0 if t0 is not None else None
        return dict(state=state, stats=stats, bounds=bounds, last_bounds=b,
                    launches=step.launches, phases=step.phases, wall=wall)

    return run_ranks(n_ranks, rank, device)


def slab_profile(spec, cfg, ranks, frames: int, frame0: int):
    """`frames` more frames from `ranks` under torch.profiler (CUDA
    activity, started on this thread: every rank's kernels): the kernels'
    summed device ms over the wall ms (the busy share; thread start
    included), and (ms a frame, launches a frame, name) of each kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slab_run(spec, cfg, None, torch.device("cuda", 0), frames, motion=True, start=ranks,
                 frame0=frame0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / wall_ms
    return busy, sorted(((e.self_device_time_total / 1e3 / frames, e.count // frames,
                          e.key[:70]) for e in ev), reverse=True)


def slab_soa(ranks):
    from pbf_sph_tpu_torch.parallel import sharded

    return sharded.gather_soa([r["state"] for r in ranks]).order_by_id()


def check_soa_close(a, b, tols, what: str) -> None:
    check(np.array_equal(a.pid, b.pid), f"{what}: the same {len(a)} particle ids")
    errs = {name: float(np.abs(getattr(a, name) - getattr(b, name)).max()) for name, _ in tols}
    check(all(errs[name] <= atol for name, atol in tols),
          f"{what}: " + ", ".join(f"{n} max abs err {errs[n]:.3e} <= {t}" for n, t in tols))


def check_slab_launches(ranks, frames: int, iteration: int, what: str) -> dict:
    """Each rank: 1 diffuse_cell_sums + 1 diffuse_cells + iteration
    lambda_cells + iteration delta_cells a frame, 0 of the per-row kernels.
    Returns the launches summed over the ranks."""
    want = dict.fromkeys(SLAB_ZERO, 0)
    want.update(diffuse_cell_sums=frames, diffuse_cells=frames,
                lambda_cells=iteration * frames, delta_cells=iteration * frames)
    got = [r["launches"] for r in ranks]
    check(all(g == want for g in got),
          f"{what}: every rank's launches {want} ({2 + 2 * iteration} x {frames} frames)")
    return {k: sum(g[k] for g in got) for k in want}


def check_slab_kernels(ranks, what: str = "slab frame") -> None:
    """The kernels of the busiest rank's first slab (or tile) frame against
    their plain versions on its inputs, on the card: the diffuse pair with
    torch.equal, λ (atol 1e-6, rtol 1e-5) and pStar after Δp and the clamp
    (atol 1e-5) as 3l holds them.  Direct kernel calls: no wrapper counts
    them."""
    from pbf_sph_tpu_torch.core.types import FLUID
    from pbf_sph_tpu_torch.ops import cells
    from pbf_sph_tpu_torch.ops import diffuse_cells as dc

    r = max(ranks, key=lambda r: int(r["stats"][0]["alive_count"][0]))
    ph = r["phases"]
    index, colour, ptype, alive, dt = ph.kept_diffuse
    sums_k = dc.diffuse_cell_sums_kernel(index, colour, ptype, alive)
    sums_p = dc.diffuse_cell_sums_plain(index, colour, ptype, alive)
    mix_k = dc.diffuse_cells_kernel(index, sums_p, colour, ptype, alive, dt)
    mix_p = dc.diffuse_cells_plain(index, sums_p, colour, ptype, alive, dt)
    check(torch.equal(sums_k, sums_p) and torch.equal(mix_k, mix_p),
          f"{what} (rank with {int(alive.sum())} rows alive, capacity "
          f"{alive.shape[0]}, local grid {index.grid.dims}): diffuse_cell_sums and "
          "diffuse_cells bit for bit their plain versions")
    index, pstar, mass, ptype, alive, *bounds = ph.kept_solve
    fluid = (ptype == FLUID) & alive
    pack_a = torch.stack([pstar[0], pstar[1], pstar[2], mass], dim=1)
    b_k, b_p = torch.empty_like(pack_a), torch.empty_like(pack_a)
    cells.lambda_cells_kernel(index, ph.h, pack_a, fluid, b_k)
    cells.lambda_cells_plain(index, ph.h, pack_a, fluid, b_p)
    lam_err = float((b_k - b_p).abs().max())
    check(torch.allclose(b_k, b_p, atol=1e-6, rtol=1e-5),
          f"{what}: lambda_cells max abs err {lam_err:.3e} (atol 1e-6, rtol 1e-5)")
    a_k, a_p = pack_a.clone(), pack_a.clone()
    cells.delta_cells_kernel(index, ph.h, b_p, fluid, *bounds, a_k)
    cells.delta_cells_plain(index, ph.h, b_p, fluid, *bounds, a_p)
    d_err = float((a_k - a_p).abs().max())
    check(d_err <= 1e-5 and bool(torch.isfinite(a_k).all()),
          f"{what}: delta_cells pStar max abs err {d_err:.3e} <= 1e-5, finite")


def phase_slabs_parity() -> dict:
    """9a; returns the launches of its card runs summed over ranks."""
    print("== 9a. the slab engine (parallel/sharded.py), ThreadComm ranks on cuda:0: "
          "dam_break(20_000, 3), fixed slabs, 2 frames")
    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver
    from pbf_sph_tpu_torch.ops import mc_field as mf
    from pbf_sph_tpu_torch.parallel import sharded

    mc, cfg, xs = dam_break(20_000, solver_iter=3)
    single = TorchSolver(h=cfg.h, device="cuda")
    x = xs
    for _ in range(2):
        _, x = single.advance(cfg, Scene(), x)
    x = x.order_by_id()
    card, totals = torch.device("cuda", 0), {}
    row4 = mf.ROW4_LAUNCHES["mc_field"]
    for D in (2, 4):
        spec = sharded.ShardSpec.create(cfg, D, len(xs), cfg.h, gather=False)
        ranks = slab_run(spec, cfg, xs, card, 2, probe=True)
        peaks = [int(r["stats"][-1]["ghost_peak"][0]) for r in ranks]
        alive = [int(r["stats"][-1]["alive_count"][0]) for r in ranks]
        print(f"D={D}: capacity {spec.cap_total} a rank, local grid {spec.grid_local.dims}; "
              f"alive_count {alive}, ghost_peak {peaks}")
        for k in ("migrate_dropped", "ghost_dropped", "migrate_deferred"):
            check(all(int(s[k][0]) == 0 for r in ranks for s in r["stats"]),
                  f"D={D}: {k} 0 every frame")
        if D == 4:
            check(max(peaks) > 0, f"D=4: ghosts on a boundary (ghost_peak {peaks})")
            check_slab_kernels(ranks)
        for k, v in check_slab_launches(ranks, 2, cfg.iteration, f"D={D}").items():
            totals[k] = totals.get(k, 0) + v
        got = slab_soa(ranks)
        check(len(got) == len(xs), f"D={D}: {len(got)} particles of {len(xs)}")
        cpu = slab_soa(slab_run(spec, cfg, xs, torch.device("cpu"), 2))
        check_soa_close(got, cpu, SLAB_TOLS, f"D={D} card against the CPU (plain versions)")
        check_soa_close(got, x, SLAB_SINGLE_TOLS, f"D={D} against TorchSolver(device='cuda')")
        if D == 2:
            again = slab_soa(slab_run(spec, cfg, xs, card, 2))
            check(all(np.array_equal(getattr(got, k), getattr(again, k))
                      for k in ("pid", "position", "velocity", "colour")),
                  "D=2 twice: the same bits")
    check(mf.ROW4_LAUNCHES["mc_field"] == row4,
          "row 4 (mc_field) 0 launches; the slab step holds no row-4b wrapper (McField)")
    return totals


def phase_slabs_dam1m(single_ms: float):
    """9b; returns the launches summed over ranks and the ms a frame."""
    print(f"== 9b. dam1m at D=4 with rebalance=True on the one card, sloshing bounds: "
          f"{SLAB_WARMUP} warmup + {SLAB_FRAMES} timed frames")
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.parallel import sharded

    mc, cfg, xs = WORKLOADS["dam1m"]()
    spec = sharded.ShardSpec.create(cfg, 4, len(xs), cfg.h, gather=False, rebalance=True)
    frames = SLAB_WARMUP + SLAB_FRAMES
    print(f"{len(xs)} particles; cap_local {spec.cap_local}, ghost_cap {spec.ghost_cap}, "
          f"capacity {spec.cap_total} a rank; local grid {spec.grid_local.dims}; "
          f"initial bounds {spec.initial_bounds(xs).tolist()}")
    ranks = slab_run(spec, cfg, xs, torch.device("cuda", 0), frames, motion=True,
                     timed_from=SLAB_WARMUP)
    stats = [sharded.assemble_stats([r["stats"][f] for r in ranks]) for f in range(frames)]
    for f, st in enumerate(stats):
        print(f"  frame {f}: bounds {ranks[0]['bounds'][f].tolist()}, alive_count "
              f"{st['alive_count'].tolist()}, ghost_peak {st['ghost_peak'].tolist()}, "
              f"migrate_deferred {st['migrate_deferred'].tolist()}")
    check(all(int(st["alive_count"].sum()) == len(xs) for st in stats),
          f"{len(xs)} particles every frame")
    check(all(int(st[k].sum()) == 0 for st in stats for k in ("migrate_dropped", "ghost_dropped"))
          and int(stats[-1]["migrate_deferred"].sum()) == 0,
          "migrate_dropped and ghost_dropped 0 every frame, migrate_deferred 0 at the end")
    check(all(st["extent_ok"].all() for st in stats), "extent_ok every frame")
    b0 = spec.initial_bounds(xs)
    moved = sum(not np.array_equal(b, a) for a, b in zip([b0] + ranks[0]["bounds"][:-1],
                                                         ranks[0]["bounds"]))
    check(moved >= 1, f"the bounds moved in {moved} of {frames} frames")
    totals = check_slab_launches(ranks, frames, cfg.iteration, "dam1m D=4")
    ms = 1e3 * ranks[0]["wall"] / SLAB_FRAMES
    print(f"{card_line()}: slab engine dam1m, 4 ThreadComm ranks sharing this one card "
          f"(not a multi-card speed): {ms:.3f} ms/frame over {SLAB_FRAMES} frames (host "
          f"clock); phase 5's single-chip dam1m {single_ms:.3f} ms/step")
    busy, kernels = slab_profile(spec, cfg, ranks, SLAB_PROFILED, frames)
    print(f"  {SLAB_PROFILED} more frames under torch.profiler: device busy share "
          f"{busy:.4f}, kernels {sum(k[0] for k in kernels):.3f} ms a frame in "
          f"{sum(k[1] for k in kernels)} launches; the largest (ms a frame, launches a frame, "
          "name): " + "; ".join(f"{ms_:.3f} {n} {name}" for ms_, n, name in kernels[:8]))
    return totals, ms


def phase_slabs_surface() -> dict:
    """9c; returns the launches summed over ranks."""
    print("== 9c. mc128k with its surface at D=2, rebalance=True, 2 frames")
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver
    from pbf_sph_tpu_torch.parallel import sharded

    mc, cfg, xs = WORKLOADS["mc128k"]()
    spec = sharded.ShardSpec.create(cfg, 2, len(xs), cfg.h, gather=False, rebalance=True)
    ranks = slab_run(spec, cfg, xs, torch.device("cuda", 0), 2)
    last = [r["stats"][-1] for r in ranks]
    check(all(int(s[k][0]) == 0 for s in last for k in ("mc_emit_overflow", "migrate_dropped",
                                                         "ghost_dropped")),
          "no emit overflow, no dropped particle or ghost")
    tris = [int(s["tri_count"][0]) for s in last]
    check(all(t <= spec.surface.tri_capacity for t in tris),
          f"tri_count {tris} <= tri_capacity {spec.surface.tri_capacity} a rank")
    vs, ns, cs = sharded.gather_mesh(last)
    check(len(vs) == 3 * sum(tris) == len(ns) == len(cs),
          f"gather_mesh: {len(vs)} rows = 3 x {sum(tris)} triangles")
    reach = cfg.h * spec.scale
    lo, hi = np.asarray(cfg.min_bound) - reach, np.asarray(cfg.max_bound) + reach
    check(np.isfinite(vs).all() and ((vs >= lo) & (vs <= hi)).all(),
          f"{len(vs)} vertices finite and within h*scale = {reach:.3f} of the bounds")
    single = TorchSolver(h=cfg.h, gather=True, device="cuda")
    x, res = xs, None
    for _ in range(2):
        res, x = single.advance(cfg, Scene(), x)
    t1 = len(res.mesh) // 3
    check(t1 > 0 and abs(sum(tris) - t1) <= 0.01 * t1,
          f"{sum(tris)} triangles over the slabs, {t1} from TorchSolver(gather=True) "
          "(within 1%)")
    check_soa_close(slab_soa(ranks), x.order_by_id(), SLAB_SINGLE_TOLS,
                    "mc128k D=2 against TorchSolver(gather=True)")
    return check_slab_launches(ranks, 2, cfg.iteration, "mc128k D=2")


def phase_slabs_cli() -> None:
    print("== 9d. the CLI's --multichip on bench20k: real NCCL at world size 1")
    import tempfile
    from pathlib import Path

    from pbf_sph_tpu_torch import cli
    from pbf_sph_tpu_torch.core.configs import WORKLOADS

    n = len(WORKLOADS["bench20k"]()[2])
    with tempfile.TemporaryDirectory() as tmp:
        for extra in ([], ["--rebalance"]):
            out = Path(tmp) / f"m{len(extra)}"
            argv = ["--multichip", "1", *extra, "--warmup", "2", "--iter", "3",
                    "--output", str(out)]
            rc, stats, text = run_cli(argv)
            check(rc == 0 and "Results flushed." in text and "Frame-time mean" in stats
                  and stats.get("Per-device particles") == f"[{n}]",
                  f"cli {' '.join(argv)}: rc 0, the stats block, Per-device particles [{n}]")
            count, verts = int(stats["Final Particle count"]), int(stats["Final Vertex count"])
            ply = (out / "cloud.ply").read_text().splitlines()
            obj = (out / "mesh.obj").read_text().splitlines()
            check(count == n and verts > 0 and f"element vertex {n}" in ply
                  and len(ply) - ply.index("end_header") - 1 == n
                  and sum(1 for line in obj if line.startswith("v ")) == verts,
                  f"{count} particles of {n}, {verts} vertices; cloud.ply and mesh.obj "
                  "read back")
            print(f"{card_line()}: cli --multichip 1{' --rebalance' if extra else ''}: "
                  f"frame-time mean {stats['Frame-time mean']}")
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _, _ = run_cli(["--multichip", "2", "--warmup", "0", "--iter", "1"])
    check(rc != 0 and "needs 2 CUDA devices" in err.getvalue(),
          f"cli --multichip 2 on one card: rc {rc}, {err.getvalue().strip()!r}")


def tile_moves(ranks, b0) -> tuple:
    """Frames in which the x-cuts and the y-cuts moved (rank 0's record)."""
    seq = [b0] + ranks[0]["bounds"]
    return tuple(sum(not np.array_equal(b[a], prev[a]) for prev, b in zip(seq, seq[1:]))
                 for a in range(2))


def phase_tiles_parity() -> dict:
    """9e; returns the launches of its card runs summed over ranks."""
    print("== 9e. the tile engine (parallel/sharded2d.py), 2x2 ThreadComm ranks on cuda:0: "
          "dam_break(20_000, 3), fixed cuts, 2 frames")
    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver
    from pbf_sph_tpu_torch.parallel import sharded2d

    mc, cfg, xs = dam_break(20_000, solver_iter=3)
    single = TorchSolver(h=cfg.h, device="cuda")
    x = xs
    for _ in range(2):
        _, x = single.advance(cfg, Scene(), x)
    x = x.order_by_id()
    card = torch.device("cuda", 0)
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, gather=False)
    ranks = slab_run(spec, cfg, xs, card, 2, probe=True)
    peaks = [[int(s["ghost_peak"][0]) for s in r["stats"]] for r in ranks]
    alive = [int(r["stats"][-1]["alive_count"][0]) for r in ranks]
    print(f"cuts xb {spec.xb}, yb {spec.yb}; capacity {spec.cap_total} a rank (ghost_x "
          f"{spec.ghost_x}, ghost_y {spec.ghost_y}), local grid {spec.grid_local.dims} of "
          f"{spec.grid_global.dims}; alive_count {alive}, ghost_peak a frame {peaks}")
    check(all(p > 0 for pk in peaks for p in pk), "ghost_peak > 0 on every tile, every frame")
    for k in ("migrate_dropped", "ghost_dropped", "migrate_deferred"):
        check(all(int(s[k][0]) == 0 for r in ranks for s in r["stats"]),
              f"2x2: {k} 0 every frame")
    check_slab_kernels(ranks, "tile frame")
    totals = check_slab_launches(ranks, 2, cfg.iteration, "2x2")
    got = slab_soa(ranks)
    check(len(got) == len(xs), f"2x2: {len(got)} particles of {len(xs)}")
    cpu = slab_soa(slab_run(spec, cfg, xs, torch.device("cpu"), 2))
    check_soa_close(got, cpu, SLAB_TOLS, "2x2 card against the CPU (plain versions)")
    check_soa_close(got, x, SLAB_SINGLE_TOLS, "2x2 against TorchSolver(device='cuda')")
    again = slab_soa(slab_run(spec, cfg, xs, card, 2))
    check(all(np.array_equal(getattr(got, k), getattr(again, k))
              for k in ("pid", "position", "velocity", "colour")), "2x2 twice: the same bits")
    return totals


def phase_tiles_dam1m(single_ms: float, slab_ms: float) -> dict:
    """9f; returns the launches summed over ranks."""
    print(f"== 9f. dam1m at 2x2 with rebalance=True on the one card, sloshing bounds: "
          f"{SLAB_WARMUP} warmup + {SLAB_FRAMES} timed frames, from cuts one column and "
          "one row past the equal-count ones")
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.parallel import sharded, sharded2d

    mc, cfg, xs = WORKLOADS["dam1m"]()
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, gather=False, rebalance=True)
    b0 = tuple(b.copy() for b in spec.initial_bounds())
    for b in b0:
        b[1:-1] += 1
    frames = SLAB_WARMUP + SLAB_FRAMES
    print(f"{len(xs)} particles; cap_local {spec.cap_local}, ghost_x {spec.ghost_x}, ghost_y "
          f"{spec.ghost_y}, capacity {spec.cap_total} a rank; local grid "
          f"{spec.grid_local.dims}; equal-count cuts {spec.xb}, {spec.yb}; first cuts "
          f"{[b.tolist() for b in b0]}")
    ranks = slab_run(spec, cfg, xs, torch.device("cuda", 0), frames, motion=True,
                     timed_from=SLAB_WARMUP, bounds0=b0)
    stats = [sharded.assemble_stats([r["stats"][f] for r in ranks]) for f in range(frames)]
    for f, st in enumerate(stats):
        print(f"  frame {f}: cuts {[b.tolist() for b in ranks[0]['bounds'][f]]}, alive_count "
              f"{st['alive_count'].tolist()}, ghost_peak {st['ghost_peak'].tolist()}, "
              f"migrate_deferred {st['migrate_deferred'].tolist()}")
    check(all(int(st["alive_count"].sum()) == len(xs) for st in stats),
          f"{len(xs)} particles every frame")
    check(all(int(st[k].sum()) == 0 for st in stats for k in ("migrate_dropped", "ghost_dropped"))
          and int(stats[-1]["migrate_deferred"].sum()) == 0,
          "migrate_dropped and ghost_dropped 0 every frame, migrate_deferred 0 at the end")
    check(all(st["extent_ok"].all() for st in stats), "extent_ok every frame")
    mx, my = tile_moves(ranks, b0)
    check(mx >= 1 and my >= 1, f"the x-cuts moved in {mx} and the y-cuts in {my} of {frames} "
          "frames")
    totals = check_slab_launches(ranks, frames, cfg.iteration, "dam1m 2x2")
    ms = 1e3 * ranks[0]["wall"] / SLAB_FRAMES
    print(f"{card_line()}: tile engine dam1m, 2x2 ThreadComm ranks sharing this one card "
          f"(not a multi-card speed): {ms:.3f} ms/frame over {SLAB_FRAMES} frames (host "
          f"clock); phase 5's single-chip dam1m {single_ms:.3f} ms/step, 9b's slabs "
          f"{slab_ms:.3f} ms/frame")
    busy, kernels = slab_profile(spec, cfg, ranks, SLAB_PROFILED, frames)
    print(f"  {SLAB_PROFILED} more frames under torch.profiler: device busy share "
          f"{busy:.4f}, kernels {sum(k[0] for k in kernels):.3f} ms a frame in "
          f"{sum(k[1] for k in kernels)} launches; the largest (ms a frame, launches a frame, "
          "name): " + "; ".join(f"{ms_:.3f} {n} {name}" for ms_, n, name in kernels[:8]))
    return totals


def phase_tiles_surface() -> dict:
    """9g; returns the launches summed over ranks."""
    print("== 9g. mc128k with its surface at 2x2, rebalance=True, 2 frames")
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver
    from pbf_sph_tpu_torch.parallel import sharded2d

    mc, cfg, xs = WORKLOADS["mc128k"]()
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, gather=False, rebalance=True)
    print(f"local lattice {spec.surface.sample} a tile, tri_capacity "
          f"{spec.surface.tri_capacity}, cube_cap {spec.surface.cube_cap}")
    ranks = slab_run(spec, cfg, xs, torch.device("cuda", 0), 2)
    last = [r["stats"][-1] for r in ranks]
    check(all(int(s[k][0]) == 0 for s in last for k in ("mc_emit_overflow", "migrate_dropped",
                                                         "ghost_dropped")),
          "no emit overflow, no dropped particle or ghost")
    tris = [int(s["tri_count"][0]) for s in last]
    check(all(t <= spec.surface.tri_capacity for t in tris),
          f"tri_count {tris} <= tri_capacity {spec.surface.tri_capacity} a tile")
    vs, ns, cs = sharded2d.gather_mesh(last)
    check(len(vs) == 3 * sum(tris) == len(ns) == len(cs),
          f"gather_mesh: {len(vs)} rows = 3 x {sum(tris)} triangles")
    reach = cfg.h * spec.scale
    lo, hi = np.asarray(cfg.min_bound) - reach, np.asarray(cfg.max_bound) + reach
    check(np.isfinite(vs).all() and ((vs >= lo) & (vs <= hi)).all(),
          f"{len(vs)} vertices finite and within h*scale = {reach:.3f} of the bounds")
    single = TorchSolver(h=cfg.h, gather=True, device="cuda")
    x, res = xs, None
    for _ in range(2):
        res, x = single.advance(cfg, Scene(), x)
    t1 = len(res.mesh) // 3
    check(t1 > 0 and abs(sum(tris) - t1) <= 0.01 * t1,
          f"{sum(tris)} triangles over the tiles, {t1} from TorchSolver(gather=True) "
          "(within 1%)")
    check_soa_close(slab_soa(ranks), x.order_by_id(), SLAB_SINGLE_TOLS,
                    "mc128k 2x2 against TorchSolver(gather=True)")
    return check_slab_launches(ranks, 2, cfg.iteration, "mc128k 2x2")


def phase_tiles_cli() -> None:
    print("== 9h. the CLI's --multichip NXxNY on bench20k: real NCCL at world size 1")
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from pbf_sph_tpu_torch.core.configs import WORKLOADS

    n = len(WORKLOADS["bench20k"]()[2])
    with tempfile.TemporaryDirectory() as tmp:
        for extra in ([], ["--rebalance"]):
            out = Path(tmp) / f"t{len(extra)}"
            argv = ["--multichip", "1x1", *extra, "--warmup", "2", "--iter", "3",
                    "--output", str(out)]
            rc, stats, text = run_cli(argv)
            check(rc == 0 and "Results flushed." in text and "Multichip 2D: 1x1 tiles" in text
                  and stats.get("Per-tile particles") == f"[{n}]",
                  f"cli {' '.join(argv)}: rc 0, the stats block, Per-tile particles [{n}]")
            count, verts = int(stats["Final Particle count"]), int(stats["Final Vertex count"])
            ply = (out / "cloud.ply").read_text().splitlines()
            obj = (out / "mesh.obj").read_text().splitlines()
            check(count == n and verts > 0 and f"element vertex {n}" in ply
                  and len(ply) - ply.index("end_header") - 1 == n
                  and sum(1 for line in obj if line.startswith("v ")) == verts,
                  f"{count} particles of {n}, {verts} vertices; cloud.ply and mesh.obj "
                  "read back")
            print(f"{card_line()}: cli --multichip 1x1{' --rebalance' if extra else ''}: "
                  f"frame-time mean {stats['Frame-time mean']}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _, _ = run_cli(["--multichip", "2x2", "--warmup", "0", "--iter", "1"])
    check(rc != 0 and "needs 4 CUDA devices" in err.getvalue(),
          f"cli --multichip 2x2 on one card: rc {rc}, {err.getvalue().strip()!r}")


def phase_blocked_emission() -> dict:
    print("== 10a. blocked emission: mc128k's first frame, cube_cap 0, emit_block 1024, "
          "emit_cap 128, through TorchSolver.advance")
    from pbf_sph_tpu_torch.core.configs import WORKLOADS
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of

    class Emit(TorchSolver):
        """TorchSolver whose surface spec takes `fields`."""

        def __init__(self, h, **fields):
            super().__init__(h=h, device="cuda")
            self.fields = fields

        def make_spec(self, *a, **kw):
            spec = super().make_spec(*a, **kw)
            return dataclasses.replace(spec, surface=dataclasses.replace(
                spec.surface, **self.fields))

    mc, cfg, xs = WORKLOADS["mc128k"]()
    tiny = Emit(cfg.h, cube_cap=0, emit_block=1024, emit_cap=128)
    spec, state, scn = tiny.prepare(cfg, Scene(), xs)
    _, out = tiny.step_device(spec, state, dyn_params_of(cfg, device="cuda"), scn)
    ovf = int(out["mc_emit_overflow"])
    check(ovf > 0, f"the first attempt overflows its staging rows: emit_overflow {ovf}")
    tiny.reset_launches()
    res, _ = tiny.advance(cfg, Scene(), xs)
    launches = dict(tiny.launches)
    flat, _ = Emit(cfg.h, cube_cap=0, emit_block=0, emit_cap=0).advance(cfg, Scene(), xs)
    prod, _ = TorchSolver(h=cfg.h, device="cuda").advance(cfg, Scene(), xs)
    ntri = len(res.mesh.vs) // 3
    check(ntri > 0 and all(np.array_equal(getattr(res.mesh, k), getattr(flat.mesh, k),
                                          equal_nan=True) for k in ("vs", "ns", "cs")),
          f"after the growth the mesh equals the one-stage scatter's bit for bit "
          f"({ntri} triangles)")
    check(len(prod.mesh.vs) == len(res.mesh.vs),
          f"the production spec (cube compaction) gives the same {ntri} triangles")
    for k in ("mc_field_cells", "lambda_cells", "delta_cells", "diffuse_cell_sums",
              "diffuse_cells"):
        check(launches[k] > 0, f"the advance launched {k} ({launches[k]})")
    return launches


def phase_dryrun() -> dict:
    print("== 10b. dryrun_multichip(4) on the card")
    from pbf_sph_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4)
    print(json.dumps(out))
    check(all(out[k] == 0 for k in ("migrate_dropped", "migrate_deferred", "ghost_dropped",
                                    "spawn_dropped", "query_overflow", "mc_emit_overflow")),
          "no overflow")
    check(out["tri_count"] > 0 and out["alive_count"] == out["gathered"]
          and 0 < out["alive_count"] <= out["particles"] + out["spawned"],
          f"a mesh ({out['tri_count']} triangles), {out['alive_count']} alive of "
          f"{out['particles']} + {out['spawned']} spawned, all gathered")
    launches = out["launches"]
    for k in ("lambda_cells", "delta_cells", "diffuse_cell_sums", "diffuse_cells"):
        check(launches[k] > 0, f"the ranks launched {k} ({launches[k]})")
    return launches


def run_tool(module, argv) -> dict:
    """A tool's `main(argv)` with its standard output captured; prints the
    last 14 lines before its JSON, checks rc 0 and that the JSON line names
    the card, and returns that JSON."""
    import contextlib
    import io

    name = module.__name__.rsplit(".", 1)[1]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    text = buf.getvalue()
    last = json.loads(text.strip().splitlines()[-1])
    print(f"-- {name} {' '.join(argv)}: rc {rc} in {time.perf_counter() - t0:.1f} s")
    print("\n".join(text.strip().splitlines()[:-1][-14:]))
    check(rc == 0 and last.get("card") == card_line(),
          f"{name}: rc 0, its JSON line names the card")
    return last


def phase_study_tools() -> None:
    print("== 10c. the study tools' mains at small sizes")
    from pbf_sph_tpu_torch.tools import (bench_mc_split, load_balance, micro_extract,
                                         multichip_model, precision_centered, roofline)

    runs = [
        (bench_mc_split, ["bench20k", "2"]),
        (micro_extract, ["bench20k", "1024", "4096"]),
        (roofline, ["32000", "3"]),
        (precision_centered, []),
        (load_balance, ["32000", "4", "20"]),
        (multichip_model, ["32000"]),
    ]
    os.environ["PBF_LB_REBALANCE"] = "1"
    for module, argv in runs:
        name = module.__name__.rsplit(".", 1)[1]
        last = run_tool(module, argv)
        if name == "micro_extract":
            check(last["live_rows"] > 0 and all(
                p["max_diff"] == 0.0 and not p["emit_overflow"]
                for p in last["parity"].values()),
                f"micro_extract: every emission's mesh is the production mesh "
                f"({last['live_rows']} live rows)")
        if name == "multichip_model":
            check(all(c["exchanges"] == c["model_exchanges"]
                      and c["exchange_bytes"] == c["model_bytes"]
                      for c in last["census"].values()),
                  "multichip_model: the exchange census equals the byte model")
    del os.environ["PBF_LB_REBALANCE"]


# phase 11a: `tests/test_jax_vs_oracle.py`'s criteria, (position, velocity,
# colour) atol
ORACLE_ONE_FRAME = (0.02, 0.02, 1e-3)
ORACLE_THREE_FRAMES = (0.2, 0.5, 5e-3)
ORACLE_SCENE = (0.05, 0.05, 1e-3)
DENSITY_RTOL = 2e-3
# the 2-cube scene's particle count for one frame, its surface and its
# densities, and the well/source/drain/query scene's: 14000 (13,718
# particles), the largest at which the second cube stays inside the 1000
# bound; the criteria hold there on the card (PERF.md §6).  Three frames
# with motion are checked at 2000: from 3000 up the oracle's fp32 frames
# part from its own fp64 ones by more than the criterion (the reading below)
ORACLE_COUNT = 14000
ORACLE_SCENE_COUNT = 14000
ORACLE_THREE_FRAME_COUNT = 2000


def state_errors(a, b, what: str, atols) -> dict:
    """Max abs differences of position, velocity and colour of two states in
    the same particle order, each checked against its atol."""
    check(np.array_equal(a.pid, b.pid) and np.array_equal(a.ptype, b.ptype),
          f"{what}: the same {len(a)} particle ids and types")
    errs = {}
    for name, atol in zip(("position", "velocity", "colour"), atols):
        err = float(np.abs(getattr(a, name) - getattr(b, name)).max())
        check(err <= atol, f"{what}: {name} max abs err {err:.4e} <= {atol}")
        errs[name] = err
    return errs


def mesh_errors(a, b, what: str) -> dict:
    """Triangle counts within max(3, 1%) and centroid IoU > 0.95 at 0.1
    (`test_jax_vs_oracle.py:129-148`)."""
    ta, tb = len(a.vs) // 3, len(b.vs) // 3

    def centroids(mesh):
        c = mesh.vs.reshape(-1, 3, 3).mean(axis=1)
        return {tuple(v) for v in np.round(c, 1).tolist()}

    ca, cb = centroids(a), centroids(b)
    iou = len(ca & cb) / max(1, len(ca | cb))
    check(tb > 0 and abs(ta - tb) <= max(3, 0.01 * tb),
          f"{what}: {ta} triangles on the card, {tb} through the oracle "
          f"(within max(3, 1%))")
    check(iou > 0.95, f"{what}: centroid IoU {iou:.4f} > 0.95")
    return dict(triangles=ta, oracle_triangles=tb, iou=iou)


def sph_density(xs, cfg) -> np.ndarray:
    """Per-particle SPH density of a state, the self term included, by one
    NumPy evaluator over a k-d tree's pairs within h
    (`test_jax_vs_oracle.py:71-85`)."""
    from scipy.spatial import cKDTree

    from pbf_sph_tpu_torch.ops.kernels import poly6, poly6_factor

    f = np.float32
    h = f(cfg.h)
    pos = xs.position / f(cfg.scale)
    pairs = cKDTree(pos).query_pairs(float(h), output_type="ndarray")
    p6f = f(poly6_factor(cfg.h))
    rho = np.full(len(xs), p6f * h**6, np.float64)
    d = np.linalg.norm(pos[pairs[:, 0]] - pos[pairs[:, 1]], axis=1).astype(f)
    w = poly6(d, h, p6f, np)
    np.add.at(rho, pairs[:, 0], w)
    np.add.at(rho, pairs[:, 1], w)
    return rho * xs.mass


def density_rel(a, b, cfg) -> float:
    """The largest relative difference of two states' SPH densities."""
    rho_a, rho_b = sph_density(a, cfg), sph_density(b, cfg)
    return float(np.max(np.abs(rho_a - rho_b) / np.abs(rho_b)))


def oracle_pair(cfg, scene, xs, frames: int, motion: bool = True):
    """[(result, state)] after `frames` frames through the kernel backend on
    the card and through the C++ oracle, from the same particles."""
    from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z
    from pbf_sph_tpu_torch.models.cpp_solver import CppSolver
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

    out = []
    for solver in (TorchSolver(h=cfg.h, device="cuda"), CppSolver(h=cfg.h)):
        x = xs
        for f in range(frames):
            res, x = solver.advance(apply_motion_sin_x_cos_z(cfg, f) if motion else cfg,
                                    scene, x)
        out.append((res, x))
    return out


def oracle_scene(count: int):
    """`test_jax_vs_oracle.py:98-124`'s scene (a well, a source, a drain and a
    query) over simple_config_with_2_cubes(count, 3, 500)."""
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.core.types import Drain, Query, Scene, Source, Well

    _, cfg, xs = simple_config_with_2_cubes(count, 3, 500.0)
    return cfg, xs, Scene(
        wells=[Well(tag=0, centre=(150.0, 30.0, 150.0), force=200.0)],
        sources=[Source(tag=777, centre=(500, 400, 500), velocity=(0, 1, 0),
                        colour=(1, 0, 0, 1), rate=9)],
        drains=[Drain(tag=0, centre=(650, 60, 650), width=80.0)],
        queries=[Query(id=3, point=(150, 30, 150))],
    )


def phase_oracles(count: int = ORACLE_COUNT, scene_count: int = ORACLE_SCENE_COUNT,
                  three_count: int = ORACLE_THREE_FRAME_COUNT) -> dict:
    print(f"== 11a. the kernel backend on the card against the C++/OpenMP oracle at {count} "
          f"particles (three frames at {three_count}, the scene at {scene_count})")
    from pbf_sph_tpu_torch.core.scene import (apply_motion_sin_x_cos_z,
                                              simple_config_with_2_cubes)
    from pbf_sph_tpu_torch.core.types import ParticleSoA, Scene
    from pbf_sph_tpu_torch.models.cpp_solver import CppSolver

    t0 = time.perf_counter()
    CppSolver(h=0.1)
    print(f"C++ oracle built and bound in {time.perf_counter() - t0:.2f} s")
    report = {"count": count, "three_count": three_count, "scene_count": scene_count}

    def oracle_fp64_gap(cfg, xs, o) -> float:
        """The oracle's three fp64 frames against its fp32 ones `o`."""
        x, solver = xs, CppSolver(h=cfg.h, dtype="float64")
        for f in range(3):
            x = solver.advance(apply_motion_sin_x_cos_z(cfg, f), Scene(), x)[1]
        return float(np.abs(x.order_by_id().position - o.order_by_id().position).max())

    _, cfg3, xs3 = simple_config_with_2_cubes(three_count, 3, 500.0)
    (_, g), (_, o) = oracle_pair(cfg3, Scene(), xs3, 3)
    report["three_frames"] = state_errors(g.order_by_id(), o.order_by_id(),
                                          f"{three_count}, three frames", ORACLE_THREE_FRAMES)
    report["three_frames"]["oracle_fp64_position"] = oracle_fp64_gap(cfg3, xs3, o)
    mc, cfg, xs = simple_config_with_2_cubes(count, 3, 500.0)
    (_, g), (_, o) = oracle_pair(cfg, Scene(), xs, 1)
    report["one_frame"] = state_errors(g.order_by_id(), o.order_by_id(),
                                       f"{count}, one frame", ORACLE_ONE_FRAME)
    # a reading: three frames at `count`, the card's and the oracle's fp64
    # positions each against the oracle's fp32
    (_, g), (_, o) = oracle_pair(cfg, Scene(), xs, 3)
    report["three_frames_at_count"] = dict(
        position=float(np.abs(g.order_by_id().position - o.order_by_id().position).max()),
        oracle_fp64_position=oracle_fp64_gap(cfg, xs, o))
    (gr, _), (orr, _) = oracle_pair(cfg.replace(surface=mc), Scene(), xs, 1)
    report["surface"] = mesh_errors(gr.mesh, orr.mesh, f"{count}, surface frame")
    # test_density_parity: one frame, no surface
    (_, g), (_, o) = oracle_pair(cfg, Scene(), xs, 1, motion=False)
    rel = density_rel(g.order_by_id(), o.order_by_id(), cfg)
    check(rel <= DENSITY_RTOL, f"{count}: density max rel err {rel:.4e} <= {DENSITY_RTOL}")
    report["density"] = rel

    cfg1, xs1, scene = oracle_scene(scene_count)
    (gr, g), (orr, o) = oracle_pair(cfg1, scene, xs1, 1, motion=False)

    def canon(x):
        # spawned particles share one tag: order by (id, rounded position)
        r = np.round(x.position, 1)
        i = np.lexsort((r[:, 2], r[:, 1], r[:, 0], x.pid))
        return ParticleSoA(x.pid[i], x.ptype[i], x.mass[i], x.position[i], x.velocity[i],
                           x.colour[i])

    check(len(g) == len(o), f"scene: {len(g)} particles on both")
    report["scene"] = state_errors(canon(g), canon(o), f"{scene_count}, the scene",
                                   ORACLE_SCENE)
    qg, qo = (set(r.queries[0].neighbours.tolist()) for r in (gr, orr))
    check(len(gr.queries) == len(orr.queries) == 1 and qg == qo and len(qg) > 0,
          f"scene: the query's {len(qg)} neighbours equal")
    print(f"{card_line()}: 11a largest differences {json.dumps(report)}")
    return report


def phase_bench20k_reading() -> dict:
    """One bench20k frame with its surface through the card and the oracle,
    a reading and not a check: its second cube spans 600..1040, past the
    1000 bound, and the constraint solve amplifies rounding there until the
    oracle parts from itself in fp64 (PERF.md §6).  The fp64 frame runs
    twice and must give the same bits."""
    print("== 11a. bench20k, one frame (a reading) and the fp64 oracle twice")
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.cpp_solver import CppSolver
    from pbf_sph_tpu_torch.native import build

    mc20, cfg20, xs20 = simple_config_with_2_cubes(20000, 6, 500.0)
    cfg20 = cfg20.replace(surface=mc20)
    (gr, g), (orr, o) = oracle_pair(cfg20, Scene(), xs20, 1, motion=False)
    (r64, o64), (r64b, o64b) = (CppSolver(h=cfg20.h, dtype="float64").advance(
        cfg20, Scene(), xs20) for _ in range(2))
    same = all(np.array_equal(getattr(o64, k), getattr(o64b, k))
               for k in ("pid", "ptype", "mass", "position", "velocity", "colour")) and all(
        np.array_equal(getattr(r64.mesh, k), getattr(r64b.mesh, k), equal_nan=True)
        for k in ("vs", "ns", "cs"))
    check(same, "bench20k: the fp64 oracle's frame, run twice in one process, bit for bit")
    g, o, o64 = g.order_by_id(), o.order_by_id(), o64.order_by_id()
    reading = dict(
        outside=int((xs20.position > 1000).any(1).sum()),
        position=float(np.abs(g.position - o.position).max()),
        density_rel=density_rel(g, o, cfg20),
        triangles=len(gr.mesh.vs) // 3, oracle_triangles=len(orr.mesh.vs) // 3,
        oracle_fp64_position=float(np.abs(o64.position - o.position).max()),
        oracle_fp64_density_rel=density_rel(o64, o, cfg20), oracle_fp64_repeats=same,
        # named by a hash of the host CPU's flags among others: a differing
        # name on the same checkout means another -march=native build
        oracle_library=build.library_path(build.tables_header()).name)
    print(f"bench20k, one frame (a reading; {host_cpu()}): {json.dumps(reading)}")
    return reading


def omp_threads() -> int:
    """OpenMP's thread count in this process (libgomp's omp_get_max_threads)."""
    import ctypes

    return int(ctypes.CDLL("libgomp.so.1").omp_get_max_threads())


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it: its model name, or, where a
    virtual machine reports that as unknown, its vendor, family and model
    numbers; with the core count."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            info.setdefault(key.strip(), val.strip())
    name = info.get("model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return f"{name}, {os.cpu_count()} cores"


def phase_oracle_cli() -> None:
    print("== 11b. the CLI through the host oracles")
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from pbf_sph_tpu_torch import cli
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.models.cpp_solver import PHASES

    means = {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl, extra, fp64, count in (("cpp", ["--iter", "2"], False, 20000),
                                         ("cpp", ["--fp64", "--phase-timings", "--iter", "2"],
                                          True, 20000),
                                         ("numpy", ["--count", "2000", "--iter", "1"], False,
                                          2000)):
            argv = ["--impl", impl, *extra, "--warmup", "1",
                    "--output", f"{tmp}/out_{{impl}}_{{type}}_{{iter}}"]
            rc, stats, text = run_cli(argv)
            check(rc == 0 and "Results flushed." in text, f"cli {' '.join(argv)}: rc 0")
            n = len(simple_config_with_2_cubes(count, 6, 500.0)[2])
            got, verts = int(stats["Final Particle count"]), int(stats["Final Vertex count"])
            check(got == n and verts > 0 and "Frame-time mean" in stats,
                  f"{impl}: the stats block, {got} particles of {n}, {verts} vertices")
            iters = int(extra[extra.index("--iter") + 1])
            out = Path(tmp) / cli.rendered_output_name("out_{impl}_{type}_{iter}", impl, fp64,
                                                       iters)
            ply = (out / "cloud.ply").read_text().splitlines()
            obj = (out / "mesh.obj").read_text().splitlines()
            check(f"element vertex {n}" in ply and len(ply) - ply.index("end_header") - 1 == n
                  and sum(1 for line in obj if line.startswith("v ")) == verts,
                  f"{impl}: {out.name}/cloud.ply holds {n} points, mesh.obj {verts} vertices")
            if "--phase-timings" in extra:
                check(text.count("Stopwatch[ advance]") == iters
                      and all(f"`{p}`" in text for p in PHASES),
                      f"cpp --fp64 --phase-timings: a table of its {len(PHASES)} phases a "
                      f"frame")
            means[f"{impl} {'fp64' if fp64 else 'fp32'} {count}"] = stats["Frame-time mean"]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _, _ = run_cli(["--impl", "cpp", "--multichip", "2", "--warmup", "0", "--iter", "1"])
    check(rc == 1 and "--multichip requires --impl torch or gather" in err.getvalue(),
          f"cli --impl cpp --multichip 2: rc {rc}, {err.getvalue().strip()!r}")
    print(f"oracle frame-time means (host clock; {host_cpu()}, {omp_threads()} OpenMP "
          f"threads, {torch.get_num_threads()} torch threads): "
          + ", ".join(f"{k}: {v}" for k, v in means.items()))
    print(card_line())


def phase_last_tools() -> None:
    print("== 11c. analyze_wcap, micro_plan and analyze_mc_windows")
    from pbf_sph_tpu_torch.tools import analyze_mc_windows, analyze_wcap, micro_plan

    run_tool(analyze_wcap, [])
    run_tool(micro_plan, [])
    last = run_tool(analyze_mc_windows, [])
    check(last["nodes"]["pairs"] > 0, f"analyze_mc_windows: {last['nodes']['pairs']} "
                                      f"node-candidate pairs")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # the port's package must come from this checkout: fail before any output
    # when the script stands alone
    import pbf_sph_tpu_torch  # noqa: F401

    phase_toolchain()
    phase_build()
    report = phase_kernels()
    row_launches = report.pop("launches_rows")
    check(all(v > 0 for v in row_launches.values()),
          f"phase 3 launched the per-row diffuse, λ and Δp kernels {row_launches}")
    tile_launches = report.pop("launches_tile")
    check(all(v > 0 for v in tile_launches.values()),
          f"phase 3c launched every tiled kernel (the cull kernels through PbfPhases, the "
          f"dense ones through DenseTiles) {tile_launches}")
    v2_launches = report.pop("launches_v2")
    check(all(v > 0 for v in v2_launches.values()),
          f"phase 3d launched every v2 kernel {v2_launches}")
    anchor_report, anchor_launches = phase_anchor()
    check(all(v > 0 for v in anchor_launches.values()),
          f"phase 3e launched every rate-anchor kernel {anchor_launches}")
    report.update(anchor_report)
    window_report, window_launches = phase_window()
    check(all(v > 0 for v in window_launches.values()),
          f"phase 3f launched every window kernel {window_launches}")
    report.update(window_report)
    report["mc_field"], lattice, states = phase_mc_field()
    bisect_report, bisect_launches = phase_mc_bisect(states)
    check(all(v > 0 for v in bisect_launches.values()),
          f"phase 3g launched every MC-field bisection kernel {bisect_launches}")
    report.update(bisect_report)
    report["mc_field_cells"] = phase_mc_field_cells(states)
    micro_report, micro_launches = phase_micro()
    check(all(v > 0 for v in micro_launches.values()),
          f"phase 3h launched every pair-chunk and loop kernel {micro_launches}")
    report.update(micro_report)
    dense_report, dense_launches = phase_dense()
    check(all(v > 0 for v in dense_launches.values()),
          f"phase 3i launched every dense-λ kernel {dense_launches}")
    report.update(dense_report)
    roll_report, roll_launches = phase_roll()
    check(all(v > 0 for v in roll_launches.values()),
          f"phase 3j launched every compaction building-block kernel {roll_launches}")
    report.update(roll_report)
    vpu_report, vpu_launches = phase_vpu()
    check(all(v > 0 for v in vpu_launches.values()),
          f"phase 3k launched every micro_vpu kernel {vpu_launches}")
    report.update(vpu_report)
    cells_report, staged_launches = phase_cells()
    check(all(v > 0 for v in staged_launches.values()),
          f"phase 3l launched the staged-walk kernels {staged_launches}")
    report.update(cells_report)
    report.update(phase_diffuse_cells())
    del states
    phase_parity()
    phase_extract(lattice)
    del lattice
    torch.cuda.empty_cache()
    launches, main_ms = phase_main_path()
    surface = phase_surface_path()
    phase_gather_parity()
    phase_gather_vs_kernels()
    phase_gather_paths()
    phase_cli()
    vis_launches = phase_visualise()
    check(vis_launches["mc_field_cells"] > 0 and vis_launches["lambda_cells"] > 0,
          "phase 8 ran the main path's kernels")
    print(f"visualise launches (phase 8, its card runs): {json.dumps(vis_launches)}")
    slab_launches = phase_slabs_parity()
    slab_dam1m, slab_ms = phase_slabs_dam1m(main_ms)
    for part in (slab_dam1m, phase_slabs_surface()):
        for k, v in part.items():
            slab_launches[k] += v
    phase_slabs_cli()
    print(f"slab engine launches (phase 9a-9c, its card runs, all ranks): "
          f"{json.dumps(slab_launches)}")
    engine2d_9e = phase_tiles_parity()
    engine2d = dict(engine2d_9e)
    for part in (phase_tiles_dam1m(main_ms, slab_ms), phase_tiles_surface()):
        for k, v in part.items():
            engine2d[k] += v
    phase_tiles_cli()
    print(f"tile engine launches (phase 9e, its card runs, all ranks, 2 frames): "
          f"{json.dumps(engine2d_9e)}; 9e-9g: {json.dumps(engine2d)}")
    emit_launches = phase_blocked_emission()
    dry_launches = phase_dryrun()
    phase_study_tools()
    print(f"phase 10 launches: 10a {json.dumps(emit_launches)}; 10b (all ranks) "
          f"{json.dumps(dry_launches)}")
    phase_oracles()
    phase_bench20k_reading()
    phase_oracle_cli()
    phase_last_tools()
    launches["mc_field_cells"] = surface["mc_field_cells"]
    launches["mc_field"] += surface["mc_field"]  # row 4: both paths, each held at 0
    launches.update(staged_launches)
    launches.update(tile_launches)
    launches.update(v2_launches)
    launches.update(anchor_launches)
    launches.update(window_launches)
    launches.update(bisect_launches)
    launches.update(micro_launches)
    launches.update(dense_launches)
    launches.update(roll_launches)
    launches.update(vpu_launches)

    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **report[name])
        for name, (src, rep) in KERNELS.items()
    ]
    for k in kernels:
        if k["name"] in row_launches:
            k["phase_launches"] = row_launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
