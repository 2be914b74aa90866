#!/usr/bin/env python3
"""GPU smoke check of the nbody_torch port. Run from the repo root on a
machine with one NVIDIA Hopper GPU (H100):

    python3 chip_smoke.py

Phases, each printed on its own lines:
  1. the card (nvidia-smi name and power limit) and the CUDA kernels'
     build from nbody_torch/csrc/;
  2. the all-pairs kernels of csrc/allpairs.cu against their plain torch
     twins on the card, on the same inputs:
     a. n = 65,536 in float32 and float64, 2-D and 3-D, both softenings,
        the chain (exact=False, the default) and the IEEE weight, and the
        potential;
     b. ragged rows (ni 1, 31 and 4,099 against 65,573 bodies), G applied
        after the sum, and the potential of 70,001 bodies on its plan,
        whose split boundaries cut through float32 row blocks, so that a
        block's diagonal lies in two splits;
     c. the main path's shape, N = 2^20 3-D float32: the CLI's force (the
        Newton chain) and the potential, each launched twice (the two
        results bit-equal), timed with CUDA events while nvidia-smi samples
        the SM clock and the draw, beside the twin on the first 131,072
        rows (plain_ms is its time on them; on all rows it took ~120 s of
        the run); the IEEE instantiation against the same twin; the FLOP
        bound and the MUFU floor printed beside each time;
     d. 9,216 rows (18 tiles, the BVH 2-D float64 fallback's count) against
        the 2^20 bodies in float32, which the plan splits over the bodies:
        more than one split, bit-equal launches, within 1e-5 of the twin;
     e. split_sum_kernel on partial rows of that plan's shape: bit-equal to
        its plain version, timed beside it and beside torch.sum(parts, 0);
     f. float64, 2^20 rows against 2^20 bodies (the trees' exact fallback
        at its largest), sqrt3 and poly: bit-equal launches, timed, held
        against the twin on the first 8,192 rows;
     g. the 9,216 rows in float64: split, within 1e-12 of the twin, and the
        chain against the IEEE weight on the same plan (the same order of
        summation) in half-ulps of each row's sum of |term|;
  3. the all-pairs main path at full size through the CLI: 2^20 galaxy
     bodies in 3-D, and a small run whose final state must match the CPU's;
  4. energies and saving: a 65,536-body 2-D galaxy with --csv-detailed
     --save all, checked through energy.bin and positions.bin;
  5. the octree fast path (the CLI's default algorithm):
     a. one octree force evaluation of a 2^20-body galaxy, in 3-D and in
        2-D, whose far, window and entries kernel calls are recorded; each
        kernel is then run again on its recorded inputs and timed beside
        its plain twin; the entries call is launched twice (the results
        bit-equal), the plan the wrapper made printed (parts, part length,
        blocks) and timed alone, its second pass entries_sum_kernel timed
        on partial rows of the plan's shape beside its plain version
        (bit-equal) and index_add_, and the call timed again on a plan of
        one part a tile (the grid of one block a tile), beside the MUFU
        floor; the interval window's two launches bit-equal, its call on
        one part a tile (P = 1) timed beside the default P and its MUFU
        floor, its second pass parts_sum_kernel timed on partial rows of
        the call's shape and part counts beside its plain version
        (bit-equal) and torch.sum; in 3-D its poly instantiation (which
        no path of the port runs yet) held against its twin on the same
        inputs and timed; the far field's two launches bit-equal, its call
        timed on the device alone beside its MUFU floor and bytes bound,
        with the accepted nodes a tile and the kernel's SASS a pair (probe
        sass_of of csrc/group_eval.cu, run in a thread from phase 1);
     b. the CLI at full size, -n 1048576 -s 12 --algorithm octree in 3-D
        and in 2-D (the window's parts_sum_kernel launched in both);
     c. the 3-D force of (a) against the sqrt3 all-pairs kernel on the
        same sorted bodies (sanity bounds on the relative error);
     d. a 17,000-body 3-D evaluation on the card and through the CPU
        twins: equal counters, forces within 1e-5 of sum |a|;
  6. the BVH fast path (--algorithm bvh):
     a. one BVH force evaluation of a 2^20-body galaxy, in 3-D and in 2-D,
        whose far, node-mask window and entries kernel calls are recorded
        and re-run as in 5a, each timed beside its twin, the entries call
        checked and its plan printed as in 5a, the node-mask window as the
        interval window is in 5a, the far field as in 5a; the dense-mask
        window, which the BVH reaches only at n <= 16, is timed on a
        synthetic 2^20 window built from the node-mask window's slots and
        on the inputs of an n = 16 evaluation, each beside its twin, its
        two launches bit-equal, on the device alone (the call and its
        second pass), at P = 1, 2, 4 and 8 (each within 1e-4 of the
        default's max |a|), beside its MUFU floor and its SASS a pair;
     b. the CLI at full size, -n 1048576 -s 12 --algorithm bvh in 3-D and
        in 2-D, then python -m nbody_torch.probe trace --algorithm bvh of 3
        steps in each (the idle share);
     c. the 3-D force of (a) against the poly all-pairs kernel on the same
        Hilbert-sorted bodies (the sanity bounds of 5c);
     d. a 17,000-body 3-D evaluation with a window of 2 tiles and a small
        e_chunk, so that the residual and the exact fallback run, on the
        card and through the CPU twins: equal counters, forces within 1e-5
        of sum |a|;
     e. the small path, -n 10 -s 5 --algorithm bvh --theta 0, on the card
        (through the dense-mask window) and on the CPU: the same final
        state, in the same body order; then the s/step of -n 10 -s 210
        --algorithm bvh --theta 0 and -n 16 -s 210 --algorithm bvh
        --csv-total on the card (200 timed steps each);
  7. the trees' list paths (float64 runs, --precision double), through
     the list kernel group_eval_kernel and the all-pairs fallback:
     a. one float64 list-path force evaluation of a 2^20-body galaxy per
        tree (octree sqrt3, BVH poly) in 3-D and in 2-D, printing how many
        tiles each overflow cause (frontier, node cap, leaf cap, K_CELL)
        sent to the exact fallback; the list kernel call is recorded and
        re-run in both dimensions, on the CLI's work (the heads of the
        fallback's tiles zero, as the list paths pass them) and on every
        tile's heads (nbody_tpu's work, which the earlier kernel was timed on), each
        timed beside its twin (on all tiles when the first 256 extrapolate
        to under 20 s, else on those 256), held within 1e-12 of sum |term|,
        two launches bit-equal, with its pairs, bound and DP floor; the
        second pass timed on the 3-D octree call's shape; then the float32
        instantiation, driven through octree_step_force / bvh_step_force
        with list_path=True on a 2^20-body 3-D float32 galaxy, its call
        recorded and timed the same way;
     b. the CLI at full size, -n 1048576 -s 12 --precision double with
        --algorithm octree and bvh, in 3-D and in 2-D; then probe trace
        --precision double of 2 steps of each: the list kernel's (and its
        second pass's) device ms a step;
     c. the rows of (a) that went through the lists (their tiles did not
        fall back), 65,536 at most, against the float64 all-pairs kernel
        with the same softening on the same sorted bodies (the sanity
        bounds of 5c), at least 4,096 rows per tree and dimension; where
        every 3-D tile at 2^20 falls back (the octree), the 3-D check runs
        on a 2^18-body galaxy;
     d. a 17,000-body 3-D float64 galaxy with list caps of 1,024, so that
        tiles fall back, on the card and through the CPU twins: equal
        counters, forces within 1e-12 of sum |a|;
     e. -n 64 -s 5 --precision double --print-state for both trees on the
        card and on the CPU: the same printed state, in the same body
        order, values within 1e-12 relative;
  8. the all-pairs variants that python -m nbody_torch.kernel_bench runs
     (allpairs_block_kernel<ieee>, the exact=True instantiation;
     allpairs_block_kernel<float32, fast>, allpairs_mxu_kernel and its fast
     instantiation) and the decision kernels that the last three launch
     first (csrc/tile_decide.cu: tile_stats_kernel, tile_decide_kernel<fast
     | mxu | mxu-fast>, the branch of every tile pair):
     a. each against its twin at n = 65,536 in 2-D and 3-D, on uniform
        bodies unsorted and Hilbert-sorted and on sorted clusters, and at a
        ragged n: the same branch on every tile pair (the per-i-tile counts
        equal), forces within 1e-5 of sum |term| (1e-4 for the MXU kernel's
        fast instantiation, whose bf16 roundings of a weight at a tie may
        go either way), the branch shares printed; on the same bodies each
        decision's table bit-equal to its plain version (decide_torch) on
        every i-tile, its statistics too, the tile pairs that took the exact
        pass exactly those that the box tests' mirror leaves open, the
        exact pass's share printed; then two-tile layouts a few ulps either
        side of each threshold (cuda_variant_decide.straddle_layouts, at
        tiles of 64): the tables bit-equal to their plain version, both
        branches among them, each variant's branch counts equal to its
        twin's and its forces within the tolerances above;
     b. each at 2^20 in 3-D and 2-D float32 on kernel_bench's inputs
        (default_rng(0) uniform), unsorted as the main path runs them
        (every tile pair near) and Hilbert-sorted (bench.py's all-pairs
        bodies, where the far branches run), against its twin on the first
        8,192 rows: the same branch on every tile pair of those rows'
        i-tiles, forces within the tolerances of (a); each decision as in
        (a), its table against the plain version on 16 i-tiles spread over
        the range. On the 3-D sorted bodies each variant is timed with CUDA
        events (its decision included) beside the Newton kernel, and
        plain_ms is the twin's measured time on those 8,192 rows (the whole
        twin would take over a minute); branch shares, the bound and the
        MUFU floor (below); each decision table timed alone and the
        statistics alone, beside their plain versions (the table's on its
        16 i-tiles);
     c. the outputs of (b) against the float64 kernel on 4,096 sampled rows,
        with nbody_tpu's tests' bounds: exact and fast within 1e-5 of max
        |a|, mxu within max(4 err32, 6e-5) and mxu-fast within 5e-3 of
        test_mxu_kernel.py's per-row measure, err32 the exact float32
        kernel's;
     d. python -m nbody_torch.kernel_bench --n 262144 --dims 2,3 --kernels
        newton,exact,fast,mxu,mxu-fast --repeats 1 as a subprocess: 10 JSON
        lines, each with the launches of its configuration;
  9. the ablation path of the fast paths (the ablate= tokens that
     python -m nbody_torch.probe knobs drives) and its three kernels:
     masked_eval_kernel (densemask), group_shared_masked_kernel (farcompact,
     desc1, desc2) and entries_lohi_kernel<packed> (packedj):
     a. one force evaluation of a 2^20-body galaxy (float32, theta 0.5, the
        fast paths' default tile, S and window) per tree, dimension and
        token (octree densemask, farcompact, packedj, desc1, desc2; BVH
        densemask, packedj), the new kernels' calls recorded and re-run,
        timed beside their plain versions (held against them on the first
        256 tiles, timed on all tiles where those extrapolate to under 20
        s), with pairs, bytes and bound as in 5a; for the dense-mask far
        field and the shared lists also what 5a prints for the far field:
        two launches bit-equal, the call on the device alone beside its
        MUFU floor and bytes bound, the nonzero weights a tile (mean, max)
        and the kernel's SASS a pair, registers and spills;
     b. on the card: the farcompact lists through the shared-list kernel
        under poly, which no path runs, within 1e-5 of sum |term| of its
        plain version on the first 256 tiles; the packed entries kernel equals the unpacked one on
        the same entries bit for bit, and packedj forces equal the default
        path's bit for bit where two runs of the default path do (the BVH;
        the octree heap's index_add_ atomics sum in no fixed order, so
        there within 1e-6 of sum |a|);
        the densemask far field equals the bit-packed far field on the same
        accepts within 1e-5 of sum |term|; farcompact forces within 1e-5 of
        sum |a| of the default path's (its far_over tiles printed); the 3-D
        desc1 and desc2 forces against the sqrt3 all-pairs kernel (the
        bounds of 5c); and a 17,000-body 3-D evaluation per token on the
        card and through the CPU twins: equal counters (descend_*
        included), forces within 1e-5 of sum |a|;
     c. python -m nbody_torch.probe knobs oct and bvh at 2^20 as two
        subprocesses, one SPEC per token and the default path in 3-D and
        2-D: one JSON line per SPEC with its s/step and its launches;
 10. the entry-cost probes, the ports of scripts/probe_entries_kernel.py,
     probe_entry_overhead.py and probe_dma_pipeline.py, run in this
     process through python -m nbody_torch.probe's main, and their
     kernels: entries_tables_kernel, the ladder's entry_ladder_kernel<rung>
     and the copy ring dma_ring_kernel<2 | 4> (csrc/entry_probes.cu):
     a. probe entries at 2^20 bodies, E = 393,216, every mode; each mode's
        recorded kernel call re-run, timed beside its plain version and
        held against it on the first 8,192 rows (the (1024, real) call
        also with poly softening);
     b. probe entry-overhead all S 128 at S = 1,024 and 512: ideal ==
        sepmj and sel == when exactly (the probe's rel_err is 0), switch
        within 1e-5 of sum |term| of the production entries kernel on the
        same entries (the probe's switch==prod); every mode's time, pairs/s,
        MUFU floor, share of it and P printed, prod's pairs/s beside the
        ideal rung's, and the ladder's steps (each rung minus the one it
        adds a feature to, prod minus switch) in us an entry; each rung's
        S = 1,024 call re-run, timed and held against its plain version on
        all its rows, with its P, MUFU floor, SASS (probe sass_of of
        entry_probes.cu, run in a thread from phase 1: no slow-path CALL
        or FCHK, i.e. no IEEE division or root) and its registers and
        resident blocks an SM as the CUDA runtime reports them (5, no spill);
        the ideal rung's call at P = 1, 2, 4, 8, each within 1e-5 of sum
        |term| of the default's;
     c. probe dma-pipeline all with --math 1 and --math 0: each mode's
        rel_err against blockspec at most 1e-6 (the kernels sum alike,
        so 0 is expected); each call re-run, timed and held against its
        plain version, with its P, its MUFU floor (--math 1) or, --math 0,
        its time on the device alone (compare_trees.device_ms) and its
        copies' bytes a second, its registers and resident blocks an SM
        as the CUDA runtime reports them, and its SASS. blockspec is the ideal
        rung built at the ring's launch bounds (4 blocks an SM, at most
        64 registers), so the three modes are compared at one register
        budget, and each math's ms are printed side by side; the ideal
        rung's time at 5 blocks an SM (b) is printed beside blockspec's;
 11. the trees' per-body walks (csrc/tree_walk.cu: bvh_walk_kernel and
     octree_walk_kernel, one thread a body over packed records, and
     octree_pack_kernel, which packs the octree's records and ropes):
     a. on a 2^20-body galaxy in 3-D float32, 3-D float64 and 2-D float32,
        each walk over the tree its per-body path builds: the call (its
        pack included) timed with CUDA events (a warm-up, then 3 calls),
        the pack alone (the
        octree's against its plain version, bit for bit, timed beside it
        with its bytes bound), its twin on 4,096 sampled rows (128 whole
        warps of 32 consecutive sorted rows at random offsets, passed in a
        shuffled order: the kernel's rows within 1e-5 / 1e-12 of each
        row's sum of |term|, and the kernel's call on those rows bit-equal
        to the whole call's), the accepted nodes,
        direct pairs, opened nodes and iterations a body on the rows, the
        sampled warps' SIMT efficiency (their lanes' mean iterations over
        their most, from the twin's counts), the bound from them, the
        records' bytes, the registers, spills, slow-path instructions and
        global loads by width (probe sass_of of
        tree_walk.cu, run in a thread from phase 1), and the relative
        error of the walk and of the group path on the same tree against
        the exact sum (the float64 IEEE all-pairs kernel) on the rows;
     b. the CLI at full size, -n 1048576 -s 12 -d 3 --traversal per-body
        for the octree and the bvh: 12 launches of the walk kernel (and of
        octree_pack_kernel in the octree's run), and no call of a twin;
     c. s/step over 20 timed steps (-s 30) at full size in 3-D float32:
        both per-body paths, and the BVH with --sort-every 4 and with
        --refine-levels 1 beside its default run;
     d. the refinement's kernels at 2^20 in 3-D and 2-D: one BVH force
        evaluation at refine_levels 0 and 1 on the same tree, its kernel
        calls recorded; at 1, each call (the far field over the wider heap
        prefix, the node-mask window, the entries on S/2-body node ranges,
        and the exact fallback on its first 4,096 rows if a tile fell
        back) held against its twin within 1e-5 of each row's sum of
        |term| and timed; at 0, each call timed again; the counters, the
        calls' ms and each force's error against the exact poly sum
        (median 1e-3, p99 1e-2 at most) printed side by side;
 12. the replicated multi-device layouts (nbody_torch/parallel), their
     ranks one process each; on one card they share it over gloo, so
     their s/step is no scaling figure:
     a. the --mesh CLI at -n 1048576 -s 12 --csv-total, 2 ranks: all-pairs
        3-D (the ring), octree and bvh 3-D and 2-D (float32, the fast
        paths); 4 ranks: octree and bvh 3-D; 2 ranks: the float64 octree
        at 65,536 bodies (the list path). The first run goes through
        cli.run_mesh, the others of each rank count share one spawn
        (launch.run_jobs of the same cli.mesh_rank). For each: the backend,
        the ranks a card, s/step beside the single-device run's (phase 3's
        for all-pairs, an in-process run for the others), each rank's
        peak memory; every rank must launch the path's kernels (none gives
        way to its plain version) and end with rank 0's state bit for bit;
     b. one step of each sharded path on 2 ranks (the ring, both trees'
        fast paths in 3-D and 2-D at 2^20, the float64 octree list path at
        65,536) against the single-device step on the same state
        (dryrun.step_parity): the bodies in the same order, max |diff| /
        max |a| at most 1e-5 (float32) or 1e-12 (float64), every aux equal
        (the float64 list path's root mass, an atomic index_add_ on the
        card, within n * eps of it), the ranks' states bit-equal; and the
        dry run (nbody_tpu's dryrun_multichip blocks) on the same ranks;
     c. NCCL: with 2 cards or more the runs above went over it; on one
        card a world of one over NCCL sets up its group and runs the dry
        run, and the script says that NCCL was not exercised across cards.
 13. the partitioned layout (nbody_torch/parallel/tree_partitioned.py and
     distributed_sort.py), 4 ranks on the card(s):
     a. the --mesh CLI with --mesh-layout partitioned at -n 1048576 -s 12
        --csv-total: octree and bvh 3-D on 4 body ranks, the octree 3-D on
        2 x 2 (--mesh 2 --mesh-tile 2) and 2-D on 4, float32; the float64
        octree (plain torch) at 65,536 bodies on 4. The first through
        cli.run_mesh, the others in one spawn with 13b's steps. For each:
        s/step beside the single-device run's and 12a's replicated 4-rank
        run's where there is one, each rank's peak memory; every rank of a
        float32 run must launch masked_eval_bits_kernel and
        window_eval_interval_kernel, and end with the same gathered state;
     b. one step (dt 0) of each partitioned path on a 65,536-body float32
        galaxy: octree and bvh 3-D and 2-D on 4 body ranks, both 3-D on
        2 x 2; against the same step with --kernel torch (max |diff| / max
        |a| at most 1e-4, the same sorted positions), at theta 0 against
        the direct sum by allpairs_block_kernel with the tree's softening
        (at most 1e-5), at theta 0.5 a relative L2 error against it below
        0.01; beyond_budget=1 (the ring) against the exchange (1e-4); each
        step's comm accounting printed;
     c. window_eval_interval_kernel at the partitioned shape of a middle
        body rank at 2^20 (262,144 rows against its 786,432-row window), in
        tiles of 256 and of 512 rows (the port's call), timed on the card
        alone, beside the FLOP bound and the MUFU floor; both tilings held
        on the first and the last 512 rows against the plain twin;
     d. one step of the partitioned octree 3-D and 2-D and bvh 3-D at 2^20
        on 4 ranks, every masked_eval_bits_cuda call of each rank (the far
        field, the beyond sets by exchange or ring) held on 4 of its tiles
        against masked_eval_bits_torch on the same packed words.
 14. the four kernel modes of the ablate tokens (masked_eval_bits_kernel
     <tg2>, window_eval_*_kernel<full>, entries_lohi_kernel<span> and
     <packed, span>): a. each on a default path's recorded 2^20 call,
     against its twin and timed beside the default mode; b. python -m
     nbody_torch.probe knobs with one 3-D SPEC a token of each tree at 2^20.
 15. the accuracy study and its growth probe (python -m nbody_torch.probe
     accuracy | acc-growth, the ports of scripts/accuracy_study.py and
     probe_acc_growth.py), every output in a temporary directory, a run a
     tree:
     a. accuracy 1048576 0 --force-error --dims 3, fresh: the script's
        keys; each leg (fp32fast: the fast paths' kernels; f64group: the
        list kernel and the float64 fallback) against the float64
        all-pairs kernel that 2f holds to its twin, within 5c's sanity
        bounds (per-body relative error median 1e-3, p99 1e-2);
     b. acc-growth 131072 5 --dim 3: the rows per step, step 1's acc_l1 at
        most 1e-2 (the script's rule: ~1e-3 healthy, 1e-1 a bug);
     c. accuracy 65536 5 --dims 2 --evolved: the trajectory columns
        against the float64 all-pairs engine from the 50-step pre-roll,
        finite, and the reason the reference legs are skipped printed;
 16. python -m nbody_torch.probe nasa --synthetic 2000 --steps 25 (the port
     of scripts/nasa.py) on the card and with --device cpu: the octree vs
     all-pairs lines printed; each engine's final positions on the card
     within 1e-6 of each column's largest value of the CPU run's (phase 3's
     limit);
 17. python -m nbody_torch.probe mesh-scaling --n 32768 --steps 3 (the port
     of scripts/probe_mesh_scaling.py): four rows (S = 1, 2, 4, 8 ranks on
     the card(s)) with the script's keys, the backend and the ranks a card
     printed, the table written; on one card the ranks share it over gloo,
     so the table is no scaling figure.
Each of 15-17 prints its wall time; its runs count the kernels from 0
just before each run and read them just after (phase 17's ranks by layout,
summed over the ranks), and each run must launch the kernels of its path:
the fast paths' (rows 4-7), the list kernel and the float64 all-pairs
kernel (rows 9, 2), the float32 all-pairs kernel (the ring). The kernels
line gains "script_launches" (by phase) and "script_launches_in" on each
kernel these runs launched.
Phase 2's bounds (bound_ms in the kernels line): pairs times 5*dim + 3
FLOPs (+1 under sqrt3; 3*dim + 3 for the potential) over 67 TFLOP/s in
float32 or 34 in float64. Beside the float32 times it prints, and keeps
out of the kernels line, the MUFU floor: two multi-function-unit
operations a pair (a root and a reciprocal) at 16 a clock on each SM at
the data sheet's 1.98 GHz boost clock, a figure worked out, not measured.
split_sum_kernel is bound by its bytes (the partials read once, the rows
written once); library_ms is torch.sum(parts, 0), the one PyTorch call
that computes its function (in another order of addition).
entries_sum_kernel is bound by its bytes (the parts read once, the rows
written once); library_ms is index_add_ of the parts into their tiles'
rows, the one PyTorch call that computes its function (in another order
of addition). Beside the entries kernel's, the far field's and the
dense-mask window's float32 times 5a and 6a print their MUFU floors, as
phase 2 does.
parts_sum_kernel, the second pass of the three windows and the list
kernel, is bound by its bytes (the written parts read once, the rows
written once); library_ms is torch.sum over the parts, which computes
its sums once the unwritten slices are zero, as there. The two sum
passes and their library calls are timed on the device alone, queued
behind a sleep kernel so that the host has enqueued every call before
the first runs (nbody_torch/probes/compare_trees.device_ms: "ms",
"library_ms"), and as calls back to back
("call_ms", "library_call_ms"), which a pass of a few microseconds
leaves bound by the host's cost of each call; 5a, 6a and 7a print
parts_sum_kernel's time over torch.sum's. Beside the list
kernel's float64 times 7a prints its DP floor: the float64 chain's DP
instructions a pair (23 sqrt3, 21 poly in 3-D; 20 / 18 in 2-D) at 64 a
clock on each SM at the boost clock, worked out, not measured.
Every kernel call that 5a and 6a time prints its pair count, the pairs
its inputs need (all-pairs N(N-1); a window the columns it visits times
the rows; entries sum(hi - lo) times the rows; the far field the set
accept bits times the rows), and the bound: the larger of those pairs
times the FLOPs per pair (5*dim + 3 for a force, one more under sqrt3,
3*dim + 3 for the potential; a square root and a division counted as
one each) over the H100's 67 TFLOP/s in
float32 (34 TFLOP/s in float64), and the bytes (each input read once, the
output written once) over its 3.35 TB/s; the list kernel's pairs are each
tile's rows times the nonzero-mass entries of its live list heads. No
single PyTorch call computes a softened gravity
sum (torch.cdist gives distances, not forces), so library_ms is null.
Phase 8's bounds: exact and fast count 5*dim + 3 operations a pair on
either chain; the MXU kernel the larger of its FP32 chain (by branch, see
variant_bound) over 67 TFLOP/s and its MMAs as issued over 989 TFLOP/s
bf16; beside them, kept out of the kernels line, the MUFU floor (one
operation a far pair of fast and a far-fast pair of the MXU kernel, two
every other pair; worked out, not measured). The decision table is bound
by its box tests and this run's exact-pass pairs (decision_bound) against
its bytes, the statistics by their bytes. Their launches come from the
kernel_bench run of 8d, which resets the counts before each configuration
and prints them after it. Phase
10's bounds: pairs times 19 FLOPs (sqrt3, 3-D), the entries those of
its live entries' [lo, min(hi, S)), the ladder's rungs those of the
entries' lanes (all S for ideal and sepmj), so the masked rungs' full-S
pass counts only the lanes it needs; the --math 0 control E * S reads of
3 adds each, bound by its bytes (each input once; the copies themselves
move E * S * 16 bytes, printed as copied_bytes). Beside them, kept out of
bound_ms, the MUFU floor of the pairs a rung or ring computes (every lane
of each entry it runs: 4.295e9 at E = 8,192, S = 1,024), as phase 2's.
The kernels' launch counts are set to 0 just before each CLI run that
drives a main path and read just after it: the all-pairs force kernel's
float32 Newton instantiation (the one the CLI launches: exact=False, as
nbody_tpu's engine calls allpairs_accel_pallas) from the 2^20 run of
phase 3, which must launch no IEEE instantiation; its float64
instantiation from the 3-D octree run of phase 7b (the exact fallback);
the potential kernel's and split_sum_kernel's from the run of phase 4
(the 2^20 --csv-total run computes no energies; at 65,536 bodies the
plans split), the IEEE instantiation's from kernel_bench's exact
configurations in 8d; the octree
kernels' (and the entries calls' second pass entries_sum_kernel) from the
3-D run of phase 5b, the BVH's far, node-mask and
entries kernels' (and the window's second pass parts_sum_kernel) from the
3-D run of phase 6b (parts_sum_kernel's entry also carries the octree
interval window's second pass, its launches from 5b), the dense-mask
window's from the small run of phase 6e, the three ablation kernels' from
the 3-D octree SPEC of their token in 9c (densemask, farcompact, packedj;
each SPEC's run counts from 0 inside the probe), the list kernel's float64
instantiations from the 3-D runs of phase 7b (the 2-D runs' counts and
the fallback launches of the all-pairs kernel are reported beside them),
and its float32 instantiations from the float32 list-path steps of 7a
(float32 CLI runs take the fast paths, and --kernel torch the twin). The
list kernel counts each instantiation (dtype, softening) on its own.
The walks' and the pack's launches come from the two per-body runs of
phase 11b.
Phase 12 adds to each kernel it launched "mesh_launches", the launches of
12a's --mesh runs summed over their ranks (the octree's far, window and
entries kernels under their <sqrt3> names, the BVH's under <poly>).
Phase 13 adds "partitioned_launches" to rows 4 and 5, the launches of
13a's float32 runs summed over their ranks (the far field under the
tree's softening; the BVH's window, its poly instantiation, as
"partitioned_poly_launches" of the <sqrt3> entry).
Phase 11's bounds: a body's accepted nodes and direct pairs times the
FLOPs of a pair (5*dim + 3, one more under the octree's sqrt3), plus its
accepted and opened nodes times 3 (a MAC test beyond its separation),
counted on the 4,096 sampled rows and scaled to the galaxy, over 67 or 34
TFLOP/s, against the bytes of the packed records and of the rows written;
plain_ms is the twin's time on those rows; the pack's bound is its bytes
(the level arrays and bodies read once, the records written once), its
plain_ms that of octree_records_torch; no PyTorch call walks a tree or
packs its records, so library_ms is null.
Phase 10's kernels count from the probe runs: each probe sets the counts
to 0 just before a mode's calls and reports them just after, in the
mode's JSON line (entries_tables_kernel from mode (1024, real), each
rung from its entry-overhead mode at S = 1,024, the rings and the ideal
rung at the ring's launch bounds, both maths, from dma-pipeline).
Launches made to compare a kernel with its twin, and those of the other
small runs, do not count.

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without a GPU, or if any phase
fails, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the H100's boost clock, its MUFU results a clock on an SM, and the MUFU
# floor of a chain kernel (two a pair: a root and a reciprocal)
from nbody_torch.probes import MAX_SM_CLOCK_HZ, MUFU_PER_SM_CLOCK, mufu_floor_ms

SEED = 20261016
NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")  # a number of --print-state
# Per-row tolerance of a kernel against its twin, as a fraction of the row's
# sum of |term|: both sum the same terms in different orders, so they
# differ by a few ulps of that sum, times ~sqrt of the terms per partial sum.
TOL = {"float32": 1e-5, "float64": 1e-12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def scaled(got, ref, scale):
    """(max |got - ref| / scale, max |got - ref|) once the card is done;
    fails on a non-finite kernel output."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    err = ((got - ref).abs() / scale.clamp_min(torch.finfo(scale.dtype).tiny)).max().item()
    return err, (got - ref).abs().max().item()


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU.",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from nbody_torch import _build, cli
    from nbody_torch.ops import cuda_allpairs as ca

    dev = torch.device("cuda", 0)

    # -- phase 1: card and build -------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({'already built' if cached else 'nvcc ' + ' '.join(_build.NVCC_FLAGS)}) "
          f"-> {_build.library_path().name}")
    sass_job = start_sass()
    probe_sass = start_sass("entry_probes.cu")
    walk_sass = start_sass("tree_walk.cu")

    # -- phase 2: kernels vs plain twins -----------------------------------
    big = 1 << 20
    kernels = allpairs_phase(dev, big)

    # -- phase 3: the main path at full size -------------------------------
    ca.reset_launch_counts()
    argv = ["-n", str(big), "-s", "12", "-d", "3", "--algorithm", "all-pairs",
            "--workload", "galaxy", "--device", "cuda", "--csv-total"]
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.main(argv, out=out)
    wall = time.perf_counter() - t0
    phase3_launches = dict(ca.launch_counts)
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 2, f"CLI run failed: rc={rc}, output {lines!r}")
    check(lines[0] == "algorithm,dim,precision,nsteps,nbodies,total [s]", f"header {lines[0]!r}")
    fields = lines[1].split(",")
    check(fields[:5] == ["all-pairs", "3", "32", "2", str(big)], f"CSV row {lines[1]!r}")
    total = float(fields[5])
    force_launches = phase3_launches[ca.NEWTON]
    check(force_launches >= 12 and phase3_launches[ca.EXACT] == 0,
          f"the CLI launched {phase3_launches}, expected >= 12 of {ca.NEWTON} (exact=False, as "
          f"nbody_tpu's engine calls allpairs_accel_pallas) and no IEEE launch")
    per_step = total / 2
    rate = big * (big - 1) * 2 / total if total > 0 else float("inf")
    print(f"[3] python -m nbody_torch.cli {' '.join(argv)}")
    print(f"[3]   {lines[1]}  ->  {per_step:.3f} s/step, {rate:.4e} interactions/s "
          f"(N(N-1)*nsteps/total); wall {wall:.1f} s with model build and warmup; "
          f"force kernel launches {force_launches}")

    # small input: the same path on the card and on the CPU (plain twins)
    with tempfile.TemporaryDirectory() as tmp:
        finals = {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"final_{device}.bin")
            cli.main(["-n", "2048", "-s", "12", "-d", "3", "--algorithm", "all-pairs",
                      "--workload", "galaxy", "--precision", "double", "--device", device,
                      "--csv-total", "--save-state", path], out=io.StringIO())
            finals[device] = read_state(path)
    gpu, cpu = finals["cuda"], finals["cpu"]
    check(gpu.shape == (2048, 7) and bool(np.isfinite(gpu).all()), "final state malformed")
    # per column (m, x, v): float32 files of float64 states that agree to
    # ~1e-15 differ by at most one float32 ulp of the column's largest value
    diff = float((np.abs(gpu - cpu).max(axis=0) / np.abs(cpu).max(axis=0)).max())
    print(f"[3] 2048-body 3-D galaxy, 12 steps in float64: final state on the card vs "
          f"the CPU twins, max over columns of max |diff| / max |value| = {diff:.3e} "
          f"(limit 1e-6)")
    check(diff <= 1e-6, "card and CPU final states differ")

    # -- phase 4: energies and saving ----------------------------------------
    n4 = 65536
    with tempfile.TemporaryDirectory() as tmp:
        here = os.getcwd()
        os.chdir(tmp)
        try:
            out = io.StringIO()
            ca.reset_launch_counts()
            cli.main(["-n", str(n4), "-s", "3", "-d", "2", "--algorithm", "all-pairs",
                      "--workload", "galaxy", "--device", "cuda", "--csv-detailed",
                      "--save", "all"], out=out)
            phase4_launches = dict(ca.launch_counts)
            energy = Path("energy.bin").read_bytes()
            positions = Path("positions.bin").read_bytes()
        finally:
            os.chdir(here)
    row = out.getvalue().strip().splitlines()[-1].split(",")
    check(row[:5] == ["all-pairs", "2", "32", "3", str(n4)] and len(row) == 8,
          f"detailed CSV row {row!r}")
    pe_launches = phase4_launches[ca.POTENTIAL]
    check(pe_launches >= 4, f"potential kernel launched {pe_launches} times, expected >= 4")
    check(phase4_launches[ca.SPLIT_SUM] > 0, f"no split_sum_kernel launch at {n4} bodies")
    check(struct.unpack("<II", energy[:8]) == (3, 4), "energy.bin header")
    e = np.frombuffer(energy[8:], np.float32).reshape(-1, 2)
    check(e.shape == (4, 2) and bool(np.isfinite(e).all()), f"energy records {e!r}")
    check(struct.unpack("<IIII", positions[:16]) == (n4, 3, 4, 2)
          and len(positions) == 16 + 4 * n4 * 2 * 4, "positions.bin header or length")
    tot = e.sum(axis=1).astype(np.float64)
    drift = abs(tot[-1] - tot[0]) / abs(tot[0])
    print(f"[4] {n4}-body 2-D galaxy, 3 steps, --csv-detailed --save all: "
          f"{','.join(row)}; E0 = {tot[0]:.6e}, E3 = {tot[-1]:.6e}, "
          f"relative drift {drift:.3e} (limit 1e-3); launches {phase4_launches}")
    check(drift <= 1e-3, "energy drift too large")

    octree_kernels, octree_fallback, interval_sum = octree_phases(dev, big, sass_job)
    bvh_kernels, bvh_fallback = bvh_phases(dev, big, sass_job)
    list_kernels, list_fallback, list_launches = list_phases(dev, big)
    variant_kernels = variant_phases(dev, big)
    ablation_kernels = ablation_phases(dev, big, sass_job)
    probe_kernels = probe_phases(dev, big, probe_sass)
    walk_kernels = walk_phases(dev, big, walk_sass)
    # phase 3's run is 12a's single-device all-pairs run
    single_steps, mesh_steps = {mesh_key("all-pairs", 3, "float", big): per_step}, {}
    mesh_launches = mesh_phases(dev, single_steps, mesh_steps)
    part_launches = partitioned_phases(dev, single_steps, mesh_steps)
    mode_kernels = mode_phases(dev, big)
    script_launches = script_phases(dev)

    runs = {ca.NEWTON: (phase3_launches, f"phase 3: {big}-body 3-D all-pairs --csv-total"),
            ca.NEWTON64: (list_launches, f"phase 7b: {big}-body 3-D octree --precision double "
                                         "--csv-total (the exact fallback)"),
            ca.POTENTIAL: (phase4_launches, f"phase 4: {n4}-body 2-D all-pairs --csv-detailed "
                                            "--save all"),
            ca.SPLIT_SUM: (phase4_launches, f"phase 4: {n4}-body 2-D all-pairs --csv-detailed "
                                            "--save all (forces and potential split)")}
    entries = []
    for name, (launches, run) in runs.items():
        check(launches[name] > 0, f"{name} was not launched on the main path ({run})")
        entries.append({"name": name, "route": "cuda", "source": "nbody_torch/csrc/allpairs.cu",
                        "launches": launches[name], "launches_in": run, **kernels[name]})
    entries[0]["octree_fallback_launches"] = octree_fallback  # float32 sqrt3, by dimension
    entries[0]["bvh_fallback_launches"] = bvh_fallback        # float32 poly
    entries[1]["fallback_launches_3d"] = list_fallback        # by tree
    parts_sum = next(e for e in bvh_kernels if e["name"] == PARTS_SUM)
    parts_sum["octree_interval_window"] = interval_sum  # its second pass in the octree
    kernels_line = (entries + octree_kernels + bvh_kernels + list_kernels + variant_kernels
                    + ablation_kernels + probe_kernels + walk_kernels + mode_kernels)
    for entry in kernels_line:
        if mesh_launches.get(entry["name"]):
            entry["mesh_launches"] = mesh_launches[entry["name"]]
            entry["mesh_launches_in"] = "phase 12a: the --mesh CLI runs, summed over their ranks"
        if part_launches.get(entry["name"]):
            entry.update(part_launches[entry["name"]])
        if script_launches.get(entry["name"]):
            entry["script_launches"] = script_launches[entry["name"]]
            entry["script_launches_in"] = {tag: SCRIPT_RUNS[tag]
                                           for tag in script_launches[entry["name"]]}
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# H100 SXM peaks (NVIDIA's data sheet): float32 and float64 outside the
# tensor cores, HBM3
F32_FLOPS = 67e12
F64_FLOPS = 34e12
HBM_BYTES_PER_S = 3.35e12
FEW_ROWS = 9216  # 18 tiles of 512: the BVH 2-D float64 exact fallback's rows at 2^20
PLAIN_ROWS = 8192  # 2f: the float64 2^20 calls held against the twin on their first rows
BIG_PLAIN_ROWS = 131072  # 2c: the float32 2^20 calls held against the twin on their first rows


def timed_with_clock(fn, reps: int):
    """(mean ms of reps calls by CUDA events, median SM clock in MHz and
    power draw in W that nvidia-smi sampled during them)."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ms = event_ms(fn, reps)
    finally:
        smi.terminate()
        samples = smi.communicate(timeout=30)[0]
    vals = [[float(v) for v in ln.split(",")] for ln in samples.splitlines() if ln.count(",") == 1]
    clock, power = (float(np.median([v[k] for v in vals])) if vals else float("nan")
                    for k in (0, 1))
    return ms, clock, power


def allpairs_phase(dev, big: int) -> dict:
    """Phase 2: the all-pairs kernels of csrc/allpairs.cu against their
    plain twins. Returns name -> the measurements of its kernels-line
    entry (the CLI's float32 force, the float64 force, the potential and
    split_sum_kernel)."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca

    rng = np.random.default_rng(SEED)
    sms = ca.sm_count_of(dev.index)

    def bodies(n, dim, dtype):
        m = torch.tensor(rng.uniform(0.1, 1.0, n), dtype=dtype, device=dev)
        x = torch.tensor(rng.uniform(-1.0, 1.0, (n, dim)), dtype=dtype, device=dev)
        return m, x

    def report(label, dtype, err):
        tol = TOL[str(dtype).split(".")[-1]]
        print(f"[2] {label}: max |kernel - plain| / sum|term| = {err:.3e} (limit {tol:g})")
        check(err <= tol, f"{label}: scaled error {err:.3e} above {tol:g}")

    def same_bits(label, call):
        a, b = call(), call()
        torch.cuda.synchronize()
        equal = torch.equal(a, b)
        print(f"[2] {label}: two launches bit-equal: {equal}")
        check(equal, f"{label}: two launches differ")
        return a

    def form(exact):
        return "ieee" if exact else "chain"

    # -- (a) 65,536 bodies: both dtypes, dimensions, softenings and weights
    n = 65536
    for dtype in (torch.float32, torch.float64):
        eps = eps_of(dtype)
        for dim in (2, 3):
            m, x = bodies(n, dim, dtype)
            for soft in ("poly", "sqrt3"):
                ref = ca.allpairs_block_torch(x, m, x, eps, soft)
                scale = ca.allpairs_block_abs_torch(x, m, x, eps, soft)
                for exact in (False, True):
                    got = ca.allpairs_block_cuda(x, m, x, eps, soft, exact=exact)
                    report(f"block {soft} {form(exact)} {dim}-D {dtype} n={n}", dtype,
                           scaled(got, ref, scale)[0])
            got = ca.potential_rowsums_cuda(m, x, eps)
            ref = ca.potential_rowsums_torch(m, x, eps)
            report(f"potential {dim}-D {dtype} n={n}", dtype, scaled(got, ref, ref.abs())[0])

    # -- (b) ragged rows against 65,573 bodies, G after the sum, and the
    #    potential of 70,001 bodies on its plan: in float32 the plan's split
    #    boundaries cut through row blocks of 512 (a block's diagonal in two
    #    splits); a float64 row block is one tile, so its diagonal lies in
    #    one split
    for dtype in (torch.float32, torch.float64):
        eps = eps_of(dtype)
        mj, xj = bodies(n + 37, 3, dtype)
        for ni in (1, 31, 4099):
            xi = xj[:ni].contiguous()
            got = ca.allpairs_block_cuda(xi, mj, xj, eps, "poly")
            ref = ca.allpairs_block_torch(xi, mj, xj, eps, "poly")
            scale = ca.allpairs_block_abs_torch(xi, mj, xj, eps, "poly")
            report(f"block poly 3-D {dtype} ni={ni} nj={n + 37}", dtype, scaled(got, ref, scale)[0])
        G = 6.674e-11
        got = ca.allpairs_accel_cuda(mj, xj, G, eps)
        ref = G * ca.allpairs_block_torch(xj, mj, xj, eps)
        scale = G * ca.allpairs_block_abs_torch(xj, mj, xj, eps)
        report(f"accel (G={G}) 3-D {dtype} n={n + 37}", dtype, scaled(got, ref, scale)[0])
        mp, xp = bodies(70001, 3, dtype)
        ref = ca.potential_rowsums_torch(mp, xp, eps)
        plan = ca.block_plan(70001, 70001, dtype, sms)
        check(plan.splits > 1, f"{plan}: the potential of 70,001 bodies does not split")
        if dtype == torch.float32:
            check(plan.split_len % plan.rows_per_block != 0,
                  f"{plan}: no split boundary cuts a row block")
        got = ca.potential_rowsums_cuda(mp, xp, eps)
        report(f"potential 3-D {dtype} n=70001, {plan}", dtype, scaled(got, ref, ref.abs())[0])
    torch.cuda.empty_cache()

    # -- (c) the main path's shape, 2^20 3-D float32: the CLI's force (the
    #    Newton chain), the IEEE weight and the potential, timed beside the
    #    twin, with the FLOP bound and the MUFU floor
    out = {}
    pairs = big * (big - 1)
    m, x = bodies(big, 3, torch.float32)
    eps = eps_of(torch.float32)
    floor = mufu_floor_ms(pairs, sms)
    rows = BIG_PLAIN_ROWS
    for name, kern, plain, scale_fn, flops, width in (
        (ca.NEWTON, lambda: ca.allpairs_accel_cuda(m, x, 1.0, eps),
         lambda: ca.allpairs_block_torch(x[:rows], m, x, eps),
         lambda: ca.allpairs_block_abs_torch(x[:rows], m, x, eps), flops_per_pair(3, "poly"),
         3),
        (ca.POTENTIAL, lambda: ca.potential_rowsums_cuda(m, x, eps),
         lambda: ca.potential_rowsums_torch(m, x, eps, rows=rows), None, 3 * 3 + 3, 1),
    ):
        got = same_bits(f"{name} at N=2^20 3-D float32", kern)
        ms, clock, power = timed_with_clock(kern, reps=3)
        plain_ms, ref = event_ms(plain, reps=1, keep=True)
        scale = ref.abs() if scale_fn is None else scale_fn()
        err, abs_err = scaled(got[:rows], ref, scale)
        report(f"{name} at N=2^20 3-D float32 (kernel {ms:.1f} ms, plain {plain_ms:.1f} ms on "
               f"the first {rows} rows)", torch.float32, err)
        bound_ms, bound_by = bound(pairs, flops, big * 4 * (3 + 1) + big * 4 * width)
        print(f"[2] {name}: {pairs} pairs, {flops} FLOPs a pair: FLOP bound {bound_ms:.3f} ms "
              f"({bound_by}), MUFU floor {floor:.3f} ms (2 a pair at {MUFU_PER_SM_CLOCK} a "
              f"clock on {sms} SMs at {MAX_SM_CLOCK_HZ / 1e9} GHz); during the timed launches "
              f"the SM clock was {clock:.0f} MHz and the draw {power:.1f} W")
        out[name] = {"max_abs_err": abs_err, "max_scaled_err": err,
                     "scaled_err_limit": TOL["float32"], "ms": ms, "plain_ms": plain_ms,
                     "plain_rows": rows, "pairs": pairs, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "bit_equal": True,
                     "sm_clock_mhz": clock, "power_w": power, "n": big, "dim": 3,
                     "dtype": "float32"}
        if name == ca.NEWTON:
            ieee = ca.allpairs_accel_cuda(m, x, 1.0, eps, exact=True)
            ieee_ms = event_ms(lambda: ca.allpairs_accel_cuda(m, x, 1.0, eps, exact=True), reps=2)
            ieee_err = scaled(ieee[:rows], ref, scale)[0]
            report(f"{ca.EXACT} at N=2^20 3-D float32 (kernel {ieee_ms:.1f} ms)", torch.float32,
                   ieee_err)
            out[name]["ieee"] = {"ms": ieee_ms, "max_scaled_err": ieee_err}
            del ieee
        del got, ref, scale
    out[ca.NEWTON].update(replaces=f"{PALLAS_ALLPAIRS}:113",
                          also_replaces=f"{PALLAS_ALLPAIRS}:181")
    out[ca.POTENTIAL]["replaces"] = f"{PALLAS_ALLPAIRS}:255"

    # -- (d) few rows: 9,216 rows of the 2^20 bodies, which the plan splits
    #    over the bodies; float32 here, float64 in (g)
    few = {}
    xi = x[:FEW_ROWS].contiguous()
    plan = ca.block_plan(FEW_ROWS, big, torch.float32, sms)
    check(plan.splits > 1, f"{FEW_ROWS} rows against 2^20 bodies: {plan} does not split")
    for soft in ("poly", "sqrt3"):
        got = same_bits(f"few rows float32 {soft}",
                        lambda: ca.allpairs_block_cuda(xi, m, x, eps, soft))
        kms = event_ms(lambda: ca.allpairs_block_cuda(xi, m, x, eps, soft), reps=5)
        plain_ms, ref = event_ms(lambda: ca.allpairs_block_torch(xi, m, x, eps, soft), reps=1,
                                 keep=True)
        err = scaled(got, ref, ca.allpairs_block_abs_torch(xi, m, x, eps, soft))[0]
        few_pairs = FEW_ROWS * (big - 1)
        bound_ms = bound(few_pairs, flops_per_pair(3, soft), (FEW_ROWS * 2 + big) * 4 * 3
                         + big * 4)[0]
        report(f"few rows {FEW_ROWS} x 2^20 float32 {soft}, {plan} (kernel {kms:.3f} ms, "
               f"plain {plain_ms:.1f} ms, FLOP bound {bound_ms:.3f} ms, MUFU floor "
               f"{mufu_floor_ms(few_pairs, sms):.3f} ms)", torch.float32, err)
        few[soft] = {"ms": kms, "plain_ms": plain_ms, "max_scaled_err": err, "bound_ms": bound_ms,
                     "splits": plan.splits, "blocks": plan.blocks * plan.splits}
    out[ca.NEWTON]["few_rows"] = few
    # -- (e) split_sum_kernel on the partial rows of that plan's shape
    parts = torch.tensor(rng.standard_normal((plan.splits, FEW_ROWS, 3)), dtype=torch.float32,
                         device=dev)
    got = same_bits("split_sum_kernel", lambda: ca.split_sum_cuda(parts))
    sms_ms = event_ms(lambda: ca.split_sum_cuda(parts), reps=20)
    plain_ms, ref = event_ms(lambda: ca.split_sum_torch(parts), reps=1, keep=True)
    lib_ms, lib = event_ms(lambda: torch.sum(parts, 0), reps=20, keep=True)
    torch.cuda.synchronize()
    equal = torch.equal(got, ref)
    lib_err = (lib - got).abs().max().item()
    nbytes = parts.numel() * 4 + got.numel() * 4
    bound_ms, bound_by = bound(parts.numel() - got.numel(), 1, nbytes)
    print(f"[2] split_sum_kernel on ({plan.splits}, {FEW_ROWS}, 3) float32 partials: kernel "
          f"{sms_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sum(parts, 0) {lib_ms:.4f} ms; kernel "
          f"== plain bit for bit: {equal}; max |torch.sum - kernel| {lib_err:.3e}; bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    check(equal, "split_sum_kernel differs from its plain version")
    out[ca.SPLIT_SUM] = {"ms": sms_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "library_call": "torch.sum(parts, 0)",
                         "max_abs_err": (got - ref).abs().max().item(),
                         "bit_equal_to_plain": equal, "bound_ms": bound_ms, "bound_by": bound_by,
                         "replaces": f"{PALLAS_ALLPAIRS}:107-108 and :250 (the grid's sequential "
                                     "j axis: out_ref +=)",
                         "shape": [plan.splits, FEW_ROWS, 3], "dtype": "float32"}
    del m, x, xi, parts, got, ref, lib
    torch.cuda.empty_cache()

    # -- (f) float64, 2^20 rows against 2^20 bodies (the trees' exact
    #    fallback at its largest), sqrt3 and poly: held against the twin on
    #    the first PLAIN_ROWS rows; then (g) the few rows in float64, and
    #    the chain against the IEEE weight on the same plan (the same order
    #    of summation), in half-ulps of sum |term|
    m, x = bodies(big, 3, torch.float64)
    eps = eps_of(torch.float64)
    head = x[:PLAIN_ROWS].contiguous()
    f64 = {}
    for soft in ("sqrt3", "poly"):
        got = same_bits(f"{ca.NEWTON64} {soft} at 2^20 x 2^20",
                        lambda: ca.allpairs_block_cuda(x, m, x, eps, soft))
        kms, clock, power = timed_with_clock(lambda: ca.allpairs_block_cuda(x, m, x, eps, soft),
                                             reps=2)
        plain_ms, ref = event_ms(lambda: ca.allpairs_block_torch(head, m, x, eps, soft), reps=1,
                                 keep=True)
        err, abs_err = scaled(got[:PLAIN_ROWS], ref, ca.allpairs_block_abs_torch(head, m, x, eps,
                                                                                 soft))
        flops = flops_per_pair(3, soft)
        bound_ms, bound_by = bound(pairs, flops, big * 8 * 4 + big * 8 * 3, F64_FLOPS)
        report(f"{ca.NEWTON64} {soft} 2^20 x 2^20 (kernel {kms:.1f} ms; plain {plain_ms:.1f} ms "
               f"on the first {PLAIN_ROWS} rows)", torch.float64, err)
        print(f"[2] {ca.NEWTON64} {soft}: FLOP bound {bound_ms:.3f} ms ({bound_by}, {flops} FLOPs "
              f"a pair at {F64_FLOPS / 1e12:.0f} TFLOP/s); SM clock {clock:.0f} MHz, draw "
              f"{power:.1f} W")
        f64[soft] = {"ms": kms, "plain_ms": plain_ms, "plain_rows": PLAIN_ROWS,
                     "max_abs_err": abs_err, "max_scaled_err": err,
                     "scaled_err_limit": TOL["float64"], "pairs": pairs, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, "bit_equal": True,
                     "sm_clock_mhz": clock, "power_w": power}
        del got, ref
    xi = x[:FEW_ROWS].contiguous()
    plan = ca.block_plan(FEW_ROWS, big, torch.float64, sms)
    check(plan.splits > 1, f"{FEW_ROWS} float64 rows against 2^20 bodies: {plan} does not split")
    few = {}
    for soft in ("sqrt3", "poly"):
        got = same_bits(f"few rows float64 {soft}",
                        lambda: ca.allpairs_block_cuda(xi, m, x, eps, soft))
        kms = event_ms(lambda: ca.allpairs_block_cuda(xi, m, x, eps, soft), reps=3)
        ieee = ca.allpairs_block_cuda(xi, m, x, eps, soft, exact=True)
        plain_ms, ref = event_ms(lambda: ca.allpairs_block_torch(xi, m, x, eps, soft), reps=1,
                                 keep=True)
        scale = ca.allpairs_block_abs_torch(xi, m, x, eps, soft)
        err = scaled(got, ref, scale)[0]
        half_ulps = scaled(got, ieee, scale)[0] / (eps / 2)
        few_pairs = FEW_ROWS * (big - 1)
        bound_ms = bound(few_pairs, flops_per_pair(3, soft), (FEW_ROWS * 2 + big) * 8 * 3
                         + big * 8, F64_FLOPS)[0]
        report(f"few rows {FEW_ROWS} x 2^20 float64 {soft}, {plan} (kernel {kms:.3f} ms, plain "
               f"{plain_ms:.1f} ms, FLOP bound {bound_ms:.3f} ms); the chain against the IEEE "
               f"weight on the same plan: {half_ulps:.2f} half-ulps of sum|term|", torch.float64,
               err)
        few[soft] = {"ms": kms, "plain_ms": plain_ms, "max_scaled_err": err, "bound_ms": bound_ms,
                     "chain_vs_ieee_half_ulps": half_ulps, "splits": plan.splits,
                     "blocks": plan.blocks * plan.splits}
        del got, ieee, ref, scale
    out[ca.NEWTON64] = {**f64["sqrt3"], "poly": f64["poly"], "few_rows": few, "replaces": f"{PALLAS_ALLPAIRS}:181 (nbody_tpu's "
                        "float64 trees run its function in jnp)", "n": big, "dim": 3,
                        "dtype": "float64", "softening": "sqrt3"}
    del m, x, xi, head
    torch.cuda.empty_cache()
    return out


GROUP_EVAL = "nbody_torch/csrc/group_eval.cu"
PALLAS_GROUP_EVAL = "nbody_tpu/ops/pallas_group_eval.py"


def flops_per_pair(dim: int, softening: str) -> int:
    """dim subtractions, 2*dim - 1 for d2, the square root, the softening
    (poly: a multiply and an add; sqrt3: an add and two multiplies), the
    division, and 2*dim to accumulate the weighted separation."""
    return 5 * dim + 3 + (softening == "sqrt3")


def bound(pairs: int, flops: int, nbytes: int, peak: float = F32_FLOPS):
    """(least milliseconds the card could take, what bounds it)."""
    t_ops, t_bytes = pairs * flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def pairs_of(name: str, args) -> int:
    """The (row, source) pairs a group kernel's inputs need: the rows of a
    tile times the sources it visits that can add to its rows. A source of
    mass 0 (padding, a dead node) or of mask weight 0 adds exactly 0
    (0 * m / t with t >= eps > 0), so it is not counted."""
    import torch

    from nbody_torch.ops import cuda_group_eval as cg

    xi, mj = args[0], args[1]
    nj = mj.shape[0]
    live = mj != 0
    if name.startswith("masked_eval_bits"):
        words = args[3]
        return int((cg.unpack_mask_bits(words, nj) & live).sum()) * (xi.shape[0] // words.shape[0])

    def in_ranges(a, b):  # live sources in [a, b), summed over the ranges
        ends = torch.cat([live.new_zeros(1, dtype=torch.int64), live.long().cumsum(0)])
        a, b = a.clamp(0, nj), b.clamp(0, nj)
        return int((ends[b] - ends[torch.minimum(a, b)]).sum())

    if name.startswith("entries_lohi"):
        ent, lohi, n_real, S = args[3], args[4], int(args[5]), args[6]
        tb = xi.shape[0] // args[7]
        base = (ent[:n_real].long() & 0xFFFF) * S
        lohi = lohi[:n_real].long()
        return in_ranges(base + (lohi & 0xFFFF), base + ((lohi >> 16) & 0xFFFF)) * tb
    w0 = args[3].long()
    tb = xi.shape[0] // w0.shape[0]
    if name == "window_eval_interval_kernel":
        lo, hi, wt = args[4].long(), args[5].long(), args[7]
        return in_ranges(torch.maximum(lo, w0 * tb), torch.minimum(hi, (w0 + wt) * tb)) * tb
    if name not in ("window_eval_nodemask_kernel", "window_eval_dense_kernel"):
        raise ValueError(name)
    mask = args[4]
    wb = mask.shape[1] * (args[7] if name == "window_eval_nodemask_kernel" else 1)
    cols = w0[:, None] * tb + torch.arange(wb, device=w0.device)
    inside = cols < nj
    cols = cols.clamp_max(nj - 1)
    if name == "window_eval_nodemask_kernel":  # the live bodies of the open S-body slots
        keep = mask.repeat_interleave(args[7], dim=1) & live[cols]
    else:  # the columns whose weight mask[t, c] * m_j is nonzero
        keep = mask * mj[cols] != 0
    return int((keep & inside).sum()) * tb


def bytes_of(args) -> int:
    """Each distinct input tensor read once, the (rows, dim) output written once."""
    import torch

    seen = {t.data_ptr(): t.numel() * t.element_size()
            for t in args if isinstance(t, torch.Tensor)}
    return sum(seen.values()) + args[0].numel() * args[0].element_size()


def measure(tag: str, name: str, kern, twin, args, dim: int, softening: str) -> dict:
    """Time kernel `name` (5 launches after a warm-up, CUDA events) and its
    twin (one call) on the recorded args; hold it against the twin and
    both against the twin in float64, as fractions of sum |term|; count
    its pairs and compute its bound. Fails above 1e-5."""
    import torch

    got = kern(*args)  # warm-up launch
    kms = event_ms(lambda: kern(*args), reps=5)
    plain_ms, ref = event_ms(lambda: twin(*args), reps=1, keep=True)
    scale = twin(*args, absolute=True)
    err, abs_err = scaled(got, ref, scale)
    ref64 = twin(*(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                   for a in args))
    err64 = [scaled(v, ref64, scale)[0] for v in (got, ref)]
    pairs, flops = pairs_of(name, args), flops_per_pair(dim, softening)
    bound_ms, bound_by = bound(pairs, flops, bytes_of(args))
    print(f"[{tag}] {name}<{softening}>: kernel {kms:.3f} ms, plain {plain_ms:.1f} ms; max |kernel - "
          f"plain| / sum|term| = {err:.3e} (limit 1e-5); against float64: kernel {err64[0]:.3e}, "
          f"plain {err64[1]:.3e}; {pairs} pairs ({pairs / (kms * 1e-3):.4e} pairs/s), bound "
          f"{bound_ms:.3f} ms ({bound_by}, {flops} FLOPs per pair)")
    check(err <= 1e-5, f"{tag} {name}: scaled error {err:.3e} above 1e-5")
    check(err64[0] <= 1e-5, f"{tag} {name}: scaled error against float64 {err64[0]:.3e} above 1e-5")
    return {"ms": kms, "plain_ms": plain_ms, "max_abs_err": abs_err, "max_scaled_err": err,
            "max_scaled_err_vs_float64": err64[0], "pairs": pairs, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def entries_extras(tag: str, args, pairs: int) -> dict:
    """5a / 6a, the entries call beyond measure(): two launches bit-equal;
    the plan the wrapper made (entries_plan, recorded from its call)
    printed and timed alone on its inputs; its second pass
    (entries_sum_kernel) timed on partial rows of the plan's shape beside
    its plain version and index_add_; the same call on a plan of one part
    a tile (parts=1: the grid of one block a tile) held to 1e-4; the MUFU
    floor printed. Returns the extras of the kernel's entry, and the second
    pass's measurements under "sum_pass"."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.probes.compare_trees import device_ms

    xi, ntiles = args[0], args[7]
    dev, dim, tb = xi.device, xi.shape[1], xi.shape[0] // ntiles
    kern = (lambda **kw: cg.entries_lohi_eval_cuda(*args, **kw))
    with recording(cg, ["entries_plan"], results=True) as recorded:
        first = kern()
    again = kern()
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    plan, plan_args = recorded.results["entries_plan"], recorded["entries_plan"]
    target, n_parts, part_len = plan_args[5], int(plan.part_start[-1]), int(plan.part_len)
    plan_ms = event_ms(lambda: cg.entries_plan(*plan_args), reps=5)
    one_ms, one = event_ms(lambda: kern(parts=1), reps=3, keep=True)
    one_diff = ((one - first).abs().max() / first.abs().max()).item()
    kms = event_ms(kern, reps=5)
    scratch = torch.rand((plan.blocks, tb, dim), device=dev)
    got = cg.entries_sum_cuda(scratch, plan.part_start)
    sum_call_ms = event_ms(lambda: cg.entries_sum_cuda(scratch, plan.part_start), reps=20)
    sum_ms = device_ms(lambda: cg.entries_sum_cuda(scratch, plan.part_start))
    plain_ms, ref = event_ms(lambda: cg.entries_sum_torch(scratch, plan.part_start), reps=1,
                             keep=True)
    owner, flat = plan.tile[:n_parts].long(), scratch[:n_parts].view(n_parts, -1)

    def library():
        return torch.zeros(ntiles, tb * dim, device=dev).index_add_(0, owner, flat)
    lib_call_ms, lib = event_ms(library, reps=20, keep=True)
    lib_ms = device_ms(library)
    torch.cuda.synchronize()
    sum_equal = torch.equal(got, ref)
    sum_err = (got - ref).abs().max().item()
    lib_err = (lib.view_as(got) - got).abs().max().item()
    nbytes = (n_parts + ntiles) * tb * dim * 4 + plan.part_start.numel() * 4
    sum_bound, sum_by = bound((n_parts - ntiles) * tb * dim, 1, nbytes)
    floor = mufu_floor_ms(pairs, ca.sm_count_of(dev.index))
    print(f"[{tag}] entries_lohi_kernel plan: {n_parts} parts of {part_len} bodies over {ntiles} "
          f"tiles, {plan.blocks} blocks (target {target}); the plan alone {plan_ms:.3f} ms "
          f"({plan_ms / kms:.3f} of the call); two launches "
          f"{'bit-equal' if same else 'DIFFER'}; call {kms:.3f} ms against {one_ms:.3f} ms on one "
          f"part a tile (max |diff| / max |a| {one_diff:.3e}); MUFU floor {floor:.3f} ms "
          f"({floor / kms:.3f} of it)")
    print(f"[{tag}] entries_sum_kernel on ({plan.blocks}, {tb}, {dim}) partial rows, {n_parts} "
          f"parts: device {sum_ms:.4f} ms (calls back to back {sum_call_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, index_add_ device {lib_ms:.4f} ms (back to back "
          f"{lib_call_ms:.4f}); kernel == plain bit for bit: {sum_equal}; max |index_add_ - "
          f"kernel| {lib_err:.3e}; bound {sum_bound:.4f} ms ({sum_by}, {sum_bound / sum_ms:.3f} "
          f"of it)")
    check(same, f"{tag}: two entries launches on the same inputs differ")
    check(sum_equal, f"{tag}: entries_sum_kernel differs from its plain version")
    check(one_diff <= 1e-4, f"{tag}: the one-part-a-tile plan differs by {one_diff:.3e}")
    return {"bit_equal_launches": same, "one_part_a_tile_ms": one_ms,
            "plan": {"target": target, "blocks": plan.blocks, "parts": n_parts,
                     "part_len": part_len, "tiles": ntiles, "plan_ms": plan_ms},
            "sum_pass": {"ms": sum_ms, "call_ms": sum_call_ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "library_call_ms": lib_call_ms,
                         "library_call": "torch.zeros(ntiles, tb * dim).index_add_(0, tile, parts)",
                         "max_abs_err": sum_err, "bit_equal_to_plain": sum_equal,
                         "bound_ms": sum_bound, "bound_by": sum_by,
                         "shape": [plan.blocks, tb, dim], "parts": n_parts, "dtype": "float32"}}


# float64 operations a clock on an H100 SM (64 FP64 lanes), and the float64
# chain's DP instructions a pair (csrc/pair.cuh: dim subtractions, dim for
# d2, dim for the force, 6 to refine the root, 5 the quotient, and the
# softening: 3 under sqrt3, 1 under poly; 23 / 21 a 3-D pair, as the SASS
# of allpairs.cu's float64 chain counts them)
DP_PER_SM_CLOCK = 64


def dp_floor_ms(pairs: int, dim: int, softening: str, sms: int) -> float:
    """The float64 chain's DP instructions at DP_PER_SM_CLOCK a clock on
    each SM, a figure worked out, not measured."""
    per_pair = 3 * dim + 11 + (3 if softening == "sqrt3" else 1)
    return pairs * per_pair / (sms * DP_PER_SM_CLOCK * MAX_SM_CLOCK_HZ) * 1e3


def parts_sum_extras(tag: str, nparts, P: int, tb: int, dim: int, dtype) -> dict:
    """The split kernels' second pass, parts_sum_kernel, on partial rows of
    a call's shape ((ntiles * P, tb, dim), the call's part counts nparts):
    timed beside its plain version (bit-equal) and beside torch.sum over
    the parts, which computes the same sums (in another order) once the
    unwritten slices are zero, as here. Both the kernel and torch.sum are
    timed on the device alone (device_ms: "ms", "library_ms") and as calls
    back to back (event_ms: "call_ms", "library_call_ms"), whose host cost
    a pass this short may not hide."""
    import torch

    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.probes.compare_trees import device_ms

    ntiles, dev = nparts.shape[0], nparts.device
    scratch = torch.rand((ntiles, P, tb, dim), dtype=dtype, device=dev)
    scratch *= (torch.arange(P, device=dev)[None, :] < nparts[:, None])[:, :, None, None]
    scratch = scratch.view(ntiles * P, tb, dim)
    got = cg.parts_sum_cuda(scratch, nparts, P)
    call_ms = event_ms(lambda: cg.parts_sum_cuda(scratch, nparts, P), reps=20)
    ms = device_ms(lambda: cg.parts_sum_cuda(scratch, nparts, P))
    plain_ms, ref = event_ms(lambda: cg.parts_sum_torch(scratch, nparts, P), reps=1, keep=True)
    view = scratch.view(ntiles, P, tb * dim)
    lib_call_ms, lib = event_ms(lambda: torch.sum(view, 1), reps=20, keep=True)
    lib_ms = device_ms(lambda: torch.sum(view, 1))
    torch.cuda.synchronize()
    equal = torch.equal(got, ref)
    lib_err = (lib.view_as(got) - got).abs().max().item()
    written = int(nparts.sum())
    nbytes = (written + ntiles) * tb * dim * scratch.element_size() + ntiles * 4
    bound_ms, bound_by = bound(max(written - ntiles, 0) * tb * dim, 1, nbytes)
    name = str(dtype).split(".")[-1]
    print(f"[{tag}] parts_sum_kernel<{name}> on ({ntiles * P}, {tb}, {dim}) partial rows, "
          f"{written} parts written: device {ms:.4f} ms (calls back to back {call_ms:.4f}), "
          f"plain {plain_ms:.4f} ms, torch.sum device {lib_ms:.4f} ms (back to back "
          f"{lib_call_ms:.4f}); parts_sum_kernel / torch.sum {ms / lib_ms:.3f} (device), "
          f"{call_ms / lib_call_ms:.3f} (back to back); kernel == plain bit for bit: {equal}; "
          f"max |torch.sum - kernel| {lib_err:.3e}; bound {bound_ms:.4f} ms ({bound_by}, "
          f"{bound_ms / ms:.3f} of it)")
    check(equal, f"{tag}: parts_sum_kernel differs from its plain version")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_call_ms": lib_call_ms,
            "library_call": "torch.sum(parts.view(ntiles, P, tb * dim), 1) (unwritten slices 0)",
            "max_abs_err": (got - ref).abs().max().item(), "bit_equal_to_plain": equal,
            "bound_ms": bound_ms, "bound_by": bound_by, "shape": [ntiles * P, tb, dim],
            "parts": written, "dtype": name}


def launched_parts(call):
    """Run call(), one launch of a split kernel (the list kernel or a
    window), and return what it returned, the part counts (ntiles,) int32
    that the kernel wrote and its wrapper passed to parts_sum_cuda, and the
    parts a tile P it launched with."""
    from nbody_torch.ops import cuda_group_eval as cg

    with recording(cg, ["parts_sum_cuda"]) as recorded:
        out = call()
    _, nparts, P = recorded["parts_sum_cuda"]
    return out, nparts, P


def window_extras(tag: str, name: str, call, args, softening: str, pairs: int) -> dict:
    """5a / 6a, a window (the interval or the node-mask window, call its
    wrapper) beyond measure(): two launches bit-equal; the call on one part
    a tile (parts=1: the grid of one block a tile) timed and held to 1e-4
    of the default's max |a|; the MUFU floor and the default P printed; its
    second pass timed (parts_sum_extras) on the part counts the first
    launch wrote. Returns the extras of the kernel's entry, the second
    pass's measurements under "sum_pass"."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca

    xi = args[0]
    dim, dev = xi.shape[1], xi.device
    first, nparts, P = launched_parts(lambda: call(*args))
    ntiles, tb = nparts.shape[0], xi.shape[0] // nparts.shape[0]
    again = call(*args)
    one_ms, one = event_ms(lambda: call(*args, parts=1), reps=3, keep=True)
    kms = event_ms(lambda: call(*args), reps=5)
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    one_diff = ((one - first).abs().max() / first.abs().max()).item()
    floor = mufu_floor_ms(pairs, ca.sm_count_of(dev.index))
    print(f"[{tag}] {name}<{softening}>: P = {P} parts a tile ({int(nparts.sum())} parts over "
          f"{ntiles} tiles), two launches {'bit-equal' if same else 'DIFFER'}; call {kms:.3f} ms "
          f"against {one_ms:.3f} ms on one part a tile (max |diff| / max |a| {one_diff:.3e}); "
          f"MUFU floor {floor:.3f} ms ({floor / kms:.3f} of it)")
    check(same, f"{tag}: two {name} launches on the same inputs differ")
    check(one_diff <= 1e-4, f"{tag}: {name} on one part a tile differs by {one_diff:.3e}")
    return {"bit_equal_launches": same, "one_part_a_tile_ms": one_ms, "parts_a_tile": P,
            "parts": int(nparts.sum()),
            "sum_pass": parts_sum_extras(tag, nparts, P, tb, dim, xi.dtype)}


def start_sass(source: str = "group_eval.cu"):
    """Start nvcc -cubin and cuobjdump of a source of csrc/ (probe sass_of)
    in a thread and return its future: group_eval.cu's far field's and
    dense window's SASS a pair, read in 5a and 6a, and entry_probes.cu's
    rungs and rings, read in 10b and 10c, cost no wall time of their own."""
    from concurrent.futures import ThreadPoolExecutor

    from nbody_torch import _build, probe

    pool = ThreadPoolExecutor(1)
    future = pool.submit(probe.sass_of, _build.CSRC / source)
    pool.shutdown(wait=False)  # the job runs on; the pool takes no more
    return future


# the template arguments after DIM and SQRT3 of the kernels that take a mode
# (the default's, unless kernel_sass is given one)
MODE_ARGS = {"masked_eval_bits_kernel": ", (int)1", "window_eval_interval_kernel": ", (bool)0",
             "window_eval_nodemask_kernel": ", (bool)0"}


def kernel_sass(sass_job, name: str, dim: int, softening: str, mode: str | None = None) -> dict:
    """probe sass's count of a group_eval.cu kernel's hot loop (sass_job:
    start_sass's future): its instructions a pair, registers and spills.
    mode: the template arguments after DIM and SQRT3 (MODE_ARGS's default)."""
    rows = sass_job.result(timeout=600)[1]
    mode = MODE_ARGS.get(name, "") if mode is None else mode
    key = f"::{name}<(int){dim}, (bool){int(softening == 'sqrt3')}{mode}>("
    row = next(r for r in rows if key in r["kernel"])
    return {k: row.get(k) for k in ("instructions_per_pair", "registers", "spill_stores",
                                    "spill_loads", "loop_instructions", "mufu")}


def far_extras(tag: str, name: str, call, args, kept, softening: str, pairs: int,
               sass_job) -> dict:
    """5a / 6a / 9a, a far-field call (call(*args): the far field, the
    dense-mask far field or a shared-list call) beyond its timing: two
    launches bit-equal, the call on the device alone (device_ms: 20 calls
    queued behind a sleep kernel) beside its MUFU floor and its bytes bound
    (each input read once, the rows written once) with the share of each,
    the sources each tile keeps (kept (T,): mean, max; what the kernel
    compacts and stages) and the kernel's SASS a pair, registers and
    spills."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.probes.compare_trees import device_ms

    xi = args[0]
    first, again = call(*args), call(*args)
    torch.cuda.synchronize()
    same = torch.equal(first.view(torch.int32), again.view(torch.int32))
    dev_ms = device_ms(lambda: call(*args))
    floor = mufu_floor_ms(pairs, ca.sm_count_of(xi.device.index))
    bytes_ms = bytes_of(args) / HBM_BYTES_PER_S * 1e3
    kept = kept.double()
    sass = kernel_sass(sass_job, name, xi.shape[1], softening)
    print(f"[{tag}] {name}<{softening}>: {kept.shape[0]} tiles, kept a tile mean "
          f"{kept.mean().item():.1f}, max {int(kept.max())}; two launches "
          f"{'bit-equal' if same else 'DIFFER'}; device {dev_ms:.4f} ms; MUFU floor "
          f"{floor:.4f} ms ({floor / dev_ms:.3f} of it), bytes bound {bytes_ms:.4f} ms "
          f"({bytes_ms / dev_ms:.3f} of it); SASS {sass['instructions_per_pair']} a pair, "
          f"{sass['registers']} registers, spills {sass['spill_stores']} / "
          f"{sass['spill_loads']} bytes")
    check(same, f"{tag}: two {name} launches on the same inputs differ")
    return {"bit_equal_launches": same, "device_ms": dev_ms, "mufu_floor_ms": floor,
            "bytes_bound_ms": bytes_ms, "kept_mean": kept.mean().item(),
            "kept_max": int(kept.max()), "sass": sass}


DENSE_PARTS = (1, 2, 4, 8)  # 6a: the dense window's P sweep


def dense_extras(tag: str, args, pairs: int, reps: int, sass_job) -> dict:
    """6a, a dense-mask window call beyond measure(): two launches
    bit-equal, the default P, the call on the device alone (device_ms),
    at P = 1, 2, 4, 8 (CUDA events over `reps` calls) each held to 1e-4 of
    the default's max |a|, its MUFU floor and the kernel's SASS a pair."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.probes.compare_trees import device_ms

    xi, softening = args[0], args[7]
    call = cg.window_eval_dense_cuda
    first, nparts, P = launched_parts(lambda: call(*args))
    same = torch.equal(first, call(*args))
    dev_ms = device_ms(lambda: call(*args), reps=reps)
    sweep, diff = {}, 0.0
    for parts in DENSE_PARTS:
        sweep[parts], out = event_ms(lambda: call(*args, parts=parts), reps=reps, keep=True)
        diff = max(diff, ((out - first).abs().max() / first.abs().max().clamp_min(1e-30)).item())
    floor = mufu_floor_ms(pairs, ca.sm_count_of(xi.device.index))
    sass = kernel_sass(sass_job, "window_eval_dense_kernel", xi.shape[1], softening)
    print(f"[{tag}] window_eval_dense_kernel<{softening}>: P = {P} parts a tile "
          f"({int(nparts.sum())} parts over {nparts.shape[0]} tiles), two launches "
          f"{'bit-equal' if same else 'DIFFER'}; device {dev_ms:.4f} ms (the call and its "
          f"second pass); P sweep (calls back to back) "
          f"{', '.join(f'{k}: {v:.4f}' for k, v in sweep.items())} ms (max |diff| / max |a| "
          f"{diff:.3e}); MUFU floor {floor:.4f} ms ({floor / dev_ms:.3f} of it); SASS "
          f"{sass['instructions_per_pair']} a pair, {sass['registers']} registers, spills "
          f"{sass['spill_stores']} / {sass['spill_loads']} bytes")
    check(same, f"{tag}: two window_eval_dense_kernel launches on the same inputs differ")
    check(diff <= 1e-4,
          f"{tag}: window_eval_dense_kernel at other part counts differs by {diff:.3e}")
    return {"bit_equal_launches": same, "parts_a_tile": P, "parts": int(nparts.sum()),
            "device_ms": dev_ms, "ms_by_parts": sweep, "mufu_floor_ms": floor, "sass": sass}


class Recorded(dict):
    """attr -> the last call's positional args; .kwargs: attr -> its
    keyword args; .results: attr -> what it returned."""

    def __init__(self):
        super().__init__()
        self.kwargs = {}
        self.results = {}


@contextlib.contextmanager
def recording(module, attrs, key=None, results=False):
    """Wrap module.<attr> for each attr so that each call's args are kept
    (the last call's, by attr, or by key(attr, args, kwargs)) while the
    call goes through; with results=True, what it returned too."""
    recorded = Recorded()
    saved = {attr: getattr(module, attr) for attr in attrs}

    def wrap(attr, fn):
        def call(*args, **kwargs):
            k = attr if key is None else key(attr, args, kwargs)
            recorded[k] = args
            recorded.kwargs[k] = kwargs
            out = fn(*args, **kwargs)
            if results:
                recorded.results[k] = out
            return out
        return call

    for attr in attrs:
        setattr(module, attr, wrap(attr, saved[attr]))
    try:
        yield recorded
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)


def cli_full_size(algorithm: str, dim: int, big: int, tag: str,
                  precision: str = "float", extra=(), steps: int = 12):
    """-n big -s steps --csv-total (and `extra` flags) through the CLI on
    the card, with the launch counts (and the walks' twin calls) set to 0
    just before and read just after. Returns the launches, and the run's
    s/step under "s_per_step"."""
    from nbody_torch import cli
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.ops import cuda_tree_walk as tw

    ca.reset_launch_counts()
    cg.reset_launch_counts()
    tw.reset_launch_counts()
    argv = ["-n", str(big), "-s", str(steps), "-d", str(dim), "--algorithm", algorithm,
            "--workload", "galaxy", "--precision", precision, "--device", "cuda", "--csv-total",
            *extra]
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.main(argv, out=out)
    wall = time.perf_counter() - t0
    launches = {**cg.launch_counts, **ca.launch_counts, **tw.launch_counts}
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 2 and lines[0] == "algorithm,dim,precision,nsteps,nbodies,"
          "total [s]", f"{algorithm} CLI run failed: rc={rc}, output {lines!r}")
    fields = lines[1].split(",")
    bits = "64" if precision == "double" else "32"
    timed = steps - 10
    check(fields[:5] == [algorithm, str(dim), bits, str(timed), str(big)], f"CSV row {lines[1]!r}")
    per_step = float(fields[5]) / timed
    print(f"[{tag}] python -m nbody_torch.cli {' '.join(argv)}")
    print(f"[{tag}]   {lines[1]}  ->  {per_step:.4f} s/step; wall {wall:.1f} s "
          f"with model build and warmup; launches {launches}")
    return {**launches, "s_per_step": per_step}


ENTRIES_SUM = "entries_sum_kernel"  # the entries calls' second pass
PARTS_SUM = "parts_sum_kernel"  # the node-mask window's and the list kernel's second pass


def traced(tag: str, n: int, dim: int, algorithm: str, precision: str = "float",
           steps: int = 3) -> dict:
    """python -m nbody_torch.probe trace's summary of `steps` steps of an
    n-body galaxy (its kernel table not printed): wall and device time, the
    idle share, the kernels' device seconds by name."""
    import torch

    from nbody_torch import probe

    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = probe.trace(n, dim, steps, algorithm, precision, table=False)
    print(f"[{tag}] probe trace --algorithm {algorithm} -d {dim} --precision {precision} "
          f"--steps {steps}: {out.getvalue().strip()}")
    return res
OCTREE_KERNELS = {  # name -> (wrapper in ops.cuda_group_eval, twin, Pallas function replaced)
    "masked_eval_bits_kernel": ("masked_eval_bits_cuda", "masked_eval_bits_torch",
                                f"{PALLAS_GROUP_EVAL}:310"),
    "window_eval_interval_kernel": ("window_eval_interval_cuda", "window_eval_interval_torch",
                                    f"{PALLAS_GROUP_EVAL}:502"),
    "entries_lohi_kernel": ("entries_lohi_eval_cuda", "entries_lohi_eval_torch",
                            f"{PALLAS_GROUP_EVAL}:963"),
}


def octree_phases(dev, big: int, sass_job):
    """Phase 5: the octree fast path at 2^20. Returns the JSON entries of
    its three kernels and the entries' second pass, the all-pairs kernel's
    fallback launches in the CLI runs, by dimension, and the interval
    window's second pass (parts_sum_kernel, whose entry the BVH's phase
    makes): its measurements and launches in the 5b runs, by dimension.
    sass_job: start_sass's future, read in (a)."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.ops import octree
    from nbody_torch.ops import octree_group as og

    eps = eps_of(torch.float32)
    measured = {name: {} for name in OCTREE_KERNELS}
    sum_pass = {}  # the entries call's second pass, by dimension
    window_sum = {}  # the interval window's second pass, by dimension
    wrappers = [attr for attr, _, _ in OCTREE_KERNELS.values()]

    # -- (a) one real evaluation per dimension, its kernel inputs recorded
    for dim in (3, 2):
        cfg, state = build_model("galaxy", big, dim, np.float32, device=dev)
        depth = octree.max_depth(big, dim)
        lo, hi = octree.robust_quant_box(state.x)
        ms, xs, ks, _ = octree.morton_sort(state.m, state.x, lo, hi, depth)
        del state
        with recording(og, wrappers) as recorded:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            a, info = og.compute_force_grouped_fast(ms, xs, ks, depth, cfg.theta, cfg.G, cfg.eps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        counters = {k: int(v) for k, v in info.items()}
        print(f"[5a] {big}-body {dim}-D galaxy, one octree force evaluation: {wall:.3f} s wall "
              f"(first call), peak memory above its inputs {peak:.2f} GiB; {counters}")
        check(bool(torch.isfinite(a).all()), "octree force is not finite")
        check(set(recorded) == set(wrappers), f"kernels called: {sorted(recorded)}")
        for name, (attr, twin_attr, _) in OCTREE_KERNELS.items():
            measured[name][dim] = measure(f"5a {dim}-D", name, getattr(cg, attr),
                                          getattr(cg, twin_attr), recorded[attr], dim, "sqrt3")
        ent = measured["entries_lohi_kernel"][dim]
        ent.update(entries_extras(f"5a {dim}-D", recorded["entries_lohi_eval_cuda"], ent["pairs"]))
        sum_pass[dim] = ent.pop("sum_pass")
        far = measured["masked_eval_bits_kernel"][dim]
        far_args = recorded["masked_eval_bits_cuda"]
        accepted = cg.unpack_mask_bits(far_args[3], far_args[1].shape[0]).sum(1)
        far.update(far_extras(f"5a {dim}-D", "masked_eval_bits_kernel", cg.masked_eval_bits_cuda,
                              far_args, accepted, "sqrt3", far["pairs"], sass_job))
        win_args = recorded["window_eval_interval_cuda"]
        win = measured["window_eval_interval_kernel"][dim]
        win.update(window_extras(f"5a {dim}-D", "window_eval_interval_kernel",
                                 cg.window_eval_interval_cuda, win_args, "sqrt3", win["pairs"]))
        window_sum[dim] = win.pop("sum_pass")
        if dim == 3:
            # the poly instantiation, which no path of the port runs yet (the
            # partitioned BVH will), held against its twin on the same inputs
            poly = measure("5a 3-D poly", "window_eval_interval_kernel",
                           cg.window_eval_interval_cuda, cg.window_eval_interval_torch,
                           (*win_args[:8], "poly"), dim, "poly")
            floor = mufu_floor_ms(poly["pairs"], ca.sm_count_of(dev.index))
            print(f"[5a 3-D poly] MUFU floor {floor:.3f} ms ({floor / poly['ms']:.3f} of it)")
            win["poly"] = {k: poly[k] for k in ("ms", "plain_ms", "max_abs_err", "max_scaled_err",
                                                "max_scaled_err_vs_float64", "bound_ms")}
        del recorded, win_args
        if dim == 3:
            # -- (c) the 3-D force against the exact sqrt3 sum on the same bodies
            ref = cfg.G * ca.allpairs_block_cuda(xs, ms, xs, eps, "sqrt3")
            accuracy("5c", "octree vs sqrt3 all-pairs", big, a, ref)
            del ref
        del a, ms, xs, ks
        torch.cuda.empty_cache()

    # -- (b) the CLI at full size; counts from 0 just before each run ------
    launches = {dim: cli_full_size("octree", dim, big, "5b") for dim in (3, 2)}
    for dim in (3, 2):
        for name in (*OCTREE_KERNELS, ENTRIES_SUM, PARTS_SUM):
            check(launches[dim][name] > 0, f"{name} was not launched in the {dim}-D octree run")

    # -- (d) 17,000 bodies, 3-D: the card against the CPU twins -------------
    m, x = clusters(17000, 3)
    depth = octree.max_depth(17000, 3)
    runs = []
    for device in (dev, torch.device("cpu")):
        lo, hi = octree.robust_quant_box(torch.tensor(x, device=device))
        ms, xs, ks, _ = octree.morton_sort(torch.tensor(m, device=device),
                                           torch.tensor(x, device=device), lo, hi, depth)
        a, info = og.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, eps)
        runs.append((a.cpu(), {k: int(v) for k, v in info.items()}))
    card_vs_cpu("5d", "17000-body 3-D clusters", runs)

    entries = []
    for name, (_, _, replaces) in OCTREE_KERNELS.items():
        entries.append({"name": f"{name}<sqrt3>", "route": "cuda", "source": GROUP_EVAL,
                        "replaces": replaces, "launches": launches[3][name],
                        "launches_in": f"phase 5b: {big}-body 3-D octree --csv-total",
                        **measured[name][3], "n": big, "dim": 3, "dtype": "float32",
                        "launches_2d": launches[2][name], "2d": measured[name][2]})
    entries.append({"name": ENTRIES_SUM, "route": "cuda", "source": GROUP_EVAL,
                    "replaces": f"{PALLAS_GROUP_EVAL}:851, :881 (the entries grid's sequential "
                                "walk of a tile's run: zero on its first entry, then out_ref +=)",
                    "launches": launches[3][ENTRIES_SUM],
                    "launches_in": f"phase 5b: {big}-body 3-D octree --csv-total",
                    **sum_pass[3], "timed_on": "random partial rows of the 5a 3-D call's plan",
                    "launches_2d": launches[2][ENTRIES_SUM], "2d": sum_pass[2]})
    interval_sum = {**window_sum[3], "launches": launches[3][PARTS_SUM],
                    "launches_in": f"phase 5b: {big}-body 3-D octree --csv-total",
                    "timed_on": "random partial rows of the 5a 3-D interval window call's shape "
                                "and part counts",
                    "launches_2d": launches[2][PARTS_SUM], "2d": window_sum[2]}
    return entries, {dim: launches[dim][ca.NEWTON] for dim in (3, 2)}, interval_sum


BVH_KERNELS = {  # name -> (wrapper, twin, Pallas function replaced)
    "masked_eval_bits_kernel": ("masked_eval_bits_cuda", "masked_eval_bits_torch",
                                f"{PALLAS_GROUP_EVAL}:310"),
    "window_eval_nodemask_kernel": ("window_eval_nodemask_cuda", "window_eval_nodemask_torch",
                                    f"{PALLAS_GROUP_EVAL}:614"),
    "entries_lohi_kernel": ("entries_lohi_eval_cuda", "entries_lohi_eval_torch",
                            f"{PALLAS_GROUP_EVAL}:963"),
}
DENSE = ("window_eval_dense_kernel", "window_eval_dense_cuda", "window_eval_dense_torch",
         f"{PALLAS_GROUP_EVAL}:383")


# 6e: the small BVH runs that take the dense-mask window, timed through the CLI
SMALL_RUNS = (("-n", "10", "-s", "210", "--algorithm", "bvh", "--theta", "0"),
              ("-n", "16", "-s", "210", "--algorithm", "bvh"))


def small_run_step(argv, tag: str) -> float:
    """s/step of a small CLI run on the card (compare_trees.small_run_step:
    the --csv-total total over its steps after the 10 warmup steps), its
    dense-mask window launched."""
    from nbody_torch import cli
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.probes.compare_trees import small_run_step as per_step

    cg.reset_launch_counts()
    step = per_step(cli, argv)
    launches = cg.launch_counts[DENSE[0]]
    print(f"[{tag}] python -m nbody_torch.cli {' '.join(argv)} --device cuda --csv-total: "
          f"{step:.6f} s/step; window_eval_dense_kernel launches {launches}")
    check(launches > 0, f"{' '.join(argv)} launched no dense-mask window")
    return step


def bvh_phases(dev, big: int, sass_job):
    """Phase 6: the BVH fast path at 2^20. Returns the JSON entries of its
    four kernels and the all-pairs kernel's fallback launches in the CLI
    runs, by dimension. sass_job: start_sass's future, read in (a)."""
    import torch

    from nbody_torch import cli
    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh
    from nbody_torch.ops import bvh_group as bg
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.state import SystemState

    eps = eps_of(torch.float32)
    measured = {name: {} for name in (*BVH_KERNELS, DENSE[0])}
    window_sum = {}  # the window call's second pass, by dimension
    wrappers = [attr for attr, _, _ in BVH_KERNELS.values()]
    dense_kern, dense_twin = getattr(cg, DENSE[1]), getattr(cg, DENSE[2])

    # -- (a) one real evaluation per dimension, its kernel inputs recorded
    for dim in (3, 2):
        cfg, state = build_model("galaxy", big, dim, np.float32, device=dev)
        state = bvh.hilbert_sort(state, cfg.eps)
        tree = bvh.build_tree(state.m, state.x, cfg.eps)
        with recording(bg, [*wrappers, "allpairs_block_cuda"]) as recorded:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            a, info = bg.compute_force_grouped_windowed(tree, state.m, state.x, cfg.theta, cfg.G,
                                                        cfg.eps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        counters = {k: int(v) for k, v in info.items()}
        check(bool(torch.isfinite(a).all()), "BVH force is not finite")
        check(set(wrappers) <= set(recorded), f"kernels called: {sorted(recorded)}")
        check(counters["bad_entries"] == 0, "an entry addresses no tile")
        ent_args = recorded["entries_lohi_eval_cuda"]
        first, last = cg.tile_segments(ent_args[3], ent_args[5], ent_args[7])
        per_tile = (last - first - 1).double()  # entries beside each tile's sentinel
        print(f"[6a] {big}-body {dim}-D galaxy, one BVH force evaluation: {wall:.3f} s wall "
              f"(first call), peak memory above its inputs {peak:.2f} GiB; {counters}; residual "
              f"entries per tile: max {int(per_tile.max())}, mean {per_tile.mean().item():.2f} "
              f"over {per_tile.numel()} tiles")
        for name, (attr, twin_attr, _) in BVH_KERNELS.items():
            measured[name][dim] = measure(f"6a {dim}-D", name, getattr(cg, attr),
                                          getattr(cg, twin_attr), recorded[attr], dim, "poly")
        ent = measured["entries_lohi_kernel"][dim]
        ent.update(entries_extras(f"6a {dim}-D", ent_args, ent["pairs"]))
        ent["sum_pass_ms"] = ent.pop("sum_pass")["ms"]  # the kernels line's entry is 5a's
        far = measured["masked_eval_bits_kernel"][dim]
        far_args = recorded["masked_eval_bits_cuda"]
        accepted = cg.unpack_mask_bits(far_args[3], far_args[1].shape[0]).sum(1)
        far.update(far_extras(f"6a {dim}-D", "masked_eval_bits_kernel", cg.masked_eval_bits_cuda,
                              far_args, accepted, "poly", far["pairs"], sass_job))
        win = measured["window_eval_nodemask_kernel"][dim]
        win.update(window_extras(f"6a {dim}-D", "window_eval_nodemask_kernel",
                                 cg.window_eval_nodemask_cuda,
                                 recorded["window_eval_nodemask_cuda"], "poly", win["pairs"]))
        window_sum[dim] = win.pop("sum_pass")
        if "allpairs_block_cuda" in recorded:
            xi, mj, xj = recorded["allpairs_block_cuda"][:3]
            print(f"[6a] the exact fallback ran on {xi.shape[0]} rows")
        # the dense-mask window on a synthetic window of this size: the
        # node-mask call's inputs, its slots broadcast over their S bodies
        xi, mj, xj, w0, in_win, _, wt, S, _ = recorded["window_eval_nodemask_cuda"]
        mask = in_win.to(torch.float32).repeat_interleave(S, dim=1).contiguous()
        dense_args = (xi, mj, xj, w0, mask, eps, wt, "poly")
        dense = measure(f"6a {dim}-D synthetic", DENSE[0], dense_kern, dense_twin, dense_args,
                        dim, "poly")
        dense.update(dense_extras(f"6a {dim}-D synthetic", dense_args, dense["pairs"], 3,
                                  sass_job))
        measured[DENSE[0]][dim] = dense
        del dense_args
        del recorded, mask, xi, mj, xj, w0, in_win, ent_args
        if dim == 3:
            # -- (c) the 3-D force against the exact poly sum on the same bodies
            ref = cfg.G * ca.allpairs_block_cuda(state.x, state.m, state.x, eps, "poly")
            accuracy("6c", "BVH vs poly all-pairs", big, a, ref)
            del ref
        del a, state, tree
        torch.cuda.empty_cache()

    # the dense-mask window where the BVH takes it: an n = 16 evaluation
    for dim in (3, 2):
        cfg, state = build_model("galaxy", 16, dim, np.float32, device=dev)
        state = bvh.hilbert_sort(state, cfg.eps)
        tree = bvh.build_tree(state.m, state.x, cfg.eps)
        with recording(bg, [DENSE[1]]) as recorded:
            bg.compute_force_grouped_windowed(tree, state.m, state.x, 0.0, cfg.G, cfg.eps)
        check(DENSE[1] in recorded, f"the {dim}-D n = 16 evaluation took no dense-mask window")
        small = measure(f"6a {dim}-D n=16", DENSE[0], dense_kern, dense_twin, recorded[DENSE[1]],
                        dim, "poly")
        small.update(dense_extras(f"6a {dim}-D n=16", recorded[DENSE[1]], small["pairs"], 20,
                                  sass_job))
        measured[DENSE[0]][f"n16_{dim}d"] = small

    # -- (b) the CLI at full size; counts from 0 just before each run; then
    #    probe trace's idle share of 3 steps
    launches = {dim: cli_full_size("bvh", dim, big, "6b") for dim in (3, 2)}
    for dim in (3, 2):
        for name in (*BVH_KERNELS, ENTRIES_SUM, PARTS_SUM):
            check(launches[dim][name] > 0, f"{name} was not launched in the {dim}-D BVH run")
    traces = {dim: traced("6b", big, dim, "bvh") for dim in (3, 2)}

    # -- (d) 17,000 bodies, 3-D: residual and fallback, card against CPU ----
    m, x = clusters(17000, 3)
    runs = []
    for device in (dev, torch.device("cpu")):
        st = SystemState.from_numpy(m, x, np.zeros_like(x), device=device)
        st = bvh.hilbert_sort(st, eps)
        tree = bvh.build_tree(st.m, st.x, eps)
        a, info = bg.compute_force_grouped_windowed(tree, st.m, st.x, 0.5, 1.0, eps,
                                                    window_tiles=2, e_chunk=8)
        runs.append((a.cpu(), {k: int(v) for k, v in info.items()}))
    check(runs[1][1]["entries"] > 0 and runs[1][1]["fallback_tiles"] > 0,
          f"6d takes no residual or no fallback: {runs[1][1]}")
    card_vs_cpu("6d", "17000-body 3-D clusters, window_tiles 2, e_chunk 8", runs)

    # -- (e) the small path: the card (dense-mask window) against the CPU ----
    with tempfile.TemporaryDirectory() as tmp:
        finals = {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"final_{device}.bin")
            ca.reset_launch_counts()
            cg.reset_launch_counts()
            cli.main(["-n", "10", "-s", "5", "--algorithm", "bvh", "--theta", "0", "--device",
                      device, "--save-state", path], out=io.StringIO())
            if device == "cuda":
                small_launches = dict(cg.launch_counts)
            finals[device] = read_state(path)
    gpu, cpu = finals["cuda"], finals["cpu"]
    check(gpu.shape == (10, 5) and bool(np.isfinite(gpu).all()), "final state malformed")
    diff = float((np.abs(gpu - cpu).max(axis=0) / np.abs(cpu).max(axis=0)).max())
    print(f"[6e] -n 10 -s 5 --algorithm bvh --theta 0: final state on the card vs the CPU "
          f"twins, in the order each run left its bodies, max over columns of max |diff| / "
          f"max |value| = {diff:.3e} (limit 1e-4); launches on the card {small_launches}")
    check(diff <= 1e-4, "card and CPU final states differ (or their body orders do)")
    check(small_launches[DENSE[0]] > 0, "the small run did not launch the dense-mask window")
    small_steps = {" ".join(argv): small_run_step(argv, "6e") for argv in SMALL_RUNS}

    run3 = f"phase 6b: {big}-body 3-D bvh --csv-total"
    entries = []
    for name, (_, _, replaces) in BVH_KERNELS.items():
        entries.append({"name": f"{name}<poly>" if "nodemask" not in name else name,
                        "route": "cuda", "source": GROUP_EVAL, "replaces": replaces,
                        "launches": launches[3][name], "launches_in": run3,
                        **measured[name][3], "n": big, "dim": 3, "dtype": "float32",
                        "launches_2d": launches[2][name], "2d": measured[name][2]})
    entries.append({"name": PARTS_SUM, "route": "cuda", "source": GROUP_EVAL,
                    "replaces": f"{PALLAS_GROUP_EVAL}:576-580, :598 (the window grid's "
                                "sequential walk of a tile's window blocks: zero on its first "
                                "block, then out_ref +=; the list's at :52-56, :77)",
                    "launches": launches[3][PARTS_SUM], "launches_in": run3,
                    **window_sum[3], "timed_on": "random partial rows of the 6a 3-D window "
                                                 "call's shape and part counts",
                    "launches_2d": launches[2][PARTS_SUM], "2d": window_sum[2]})
    entries[1]["trace"] = {dim: {k: traces[dim][k] for k in ("wall_s", "device_s", "idle_share")}
                           for dim in (3, 2)}
    dense = measured[DENSE[0]]
    entries.append({"name": DENSE[0], "route": "cuda", "source": GROUP_EVAL, "replaces": DENSE[3],
                    "launches": small_launches[DENSE[0]],
                    "launches_in": "phase 6e: -n 10 -s 5 --algorithm bvh --theta 0 on the card",
                    **dense[3], "n": big, "dim": 3, "dtype": "float32",
                    "timed_on": "a synthetic 2^20 window from the node-mask call's slots",
                    "2d": dense[2], "n16_3d": dense["n16_3d"], "n16_2d": dense["n16_2d"],
                    "small_runs_s_per_step": small_steps})
    return entries, {dim: launches[dim][ca.NEWTON] for dim in (3, 2)}


LIST_SOFTENING = {"octree": "sqrt3", "bvh": "poly"}
LIST_CAPS = 1024  # 7d: list caps small enough that tiles of a 17,000-body galaxy fall back
MIN_LIST_ROWS = 4096  # 7c: the fewest rows evaluated through the lists that a check takes
LIST_TILE = 512  # the list paths' default tile


def list_evaluation(tree: str, dev, n: int, dim: int, caps=(None, None)):
    """One float64 list-path force evaluation of an n-body galaxy on `dev`:
    (G * accel in the tree's sorted order, its counters as ints, G, the
    sorted (m, x), the group_eval_cuda call's args and the same args with
    every tile's heads live (live_heads' inputs: nbody_tpu's work), the
    tiles sent to the exact fallback ((T,) bool), wall seconds, peak GiB
    above the inputs)."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh, bvh_group, octree, octree_group
    from nbody_torch.ops.geometry import scalar_bounds

    cfg, state = build_model("galaxy", n, dim, np.float64, device=dev)
    kw = dict(cap_nodes=caps[0], cap_leaves=caps[1])
    if tree == "octree":
        lo, hi = scalar_bounds(state.x)
        levels, _, m, x = octree.build_octree(state.m, state.x, lo, hi, octree.max_depth(n, dim))
        module, args = octree_group, (levels, m, x, hi - lo)
    else:
        st = bvh.hilbert_sort(state, cfg.eps)
        m, x = st.m, st.x
        module, args = bvh_group, (bvh.build_tree(m, x, cfg.eps), m, x)
    del state
    cuda = dev.type == "cuda"
    with recording(module, ["group_eval_cuda", "exact_fallback", "live_heads"]) as recorded:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        a, info = module.compute_force_grouped(*args, cfg.theta, cfg.G, cfg.eps, **kw)
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if cuda else 0.0
    ncnt, lcnt, _ = recorded["live_heads"]
    args = recorded["group_eval_cuda"]
    every = (*args[:6], ncnt.to(torch.int32), lcnt.to(torch.int32))  # no tile skipped
    return (a, {k: int(v) for k, v in info.items()}, cfg.G, (m, x), (args, every),
            recorded["exact_fallback"][2], wall, peak)


def list_step_float32(tree: str, dev, n: int):
    """The float32 list path through the step function a user calls,
    octree_step_force / bvh_step_force with list_path=True, on an n-body
    3-D galaxy: the launch counts set to 0 just before and read just after,
    its group_eval_cuda call's args, and the same args with every tile's
    heads live (live_heads' inputs)."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh, bvh_group, octree, octree_group
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg

    cfg, state = build_model("galaxy", n, 3, np.float32, device=dev)
    ca.reset_launch_counts()
    cg.reset_launch_counts()
    with recording(octree_group if tree == "octree" else bvh_group,
                   ["group_eval_cuda", "live_heads"]) as rec:
        if tree == "octree":
            out, _ = octree.octree_step_force(state, cfg.theta, cfg.G, cfg.eps,
                                              octree.max_depth(n, 3), list_path=True)
        else:
            out, _ = bvh.bvh_step_force(state, cfg.theta, cfg.G, cfg.eps, list_path=True)
        torch.cuda.synchronize()
    launches = {**cg.launch_counts, **ca.launch_counts}
    check(bool(torch.isfinite(out.a).all()), f"float32 {tree} list-path step force is not finite")
    print(f"[7a] {n}-body 3-D float32 galaxy, {tree}_step_force(list_path=True): launches "
          f"{launches}")
    args = rec["group_eval_cuda"]
    ncnt, lcnt, _ = rec["live_heads"]
    return launches, args, (*args[:6], ncnt.to(torch.int32), lcnt.to(torch.int32))


def list_accuracy(tree: str, n: int, dim: int, a, G: float, m, x, tile_over) -> int:
    """7c: the rows of the tiles evaluated through the lists (not sent to
    the exact fallback), 65,536 of them at most, evenly spaced, against
    the float64 all-pairs kernel with the tree's softening (the sanity
    bounds of 5c). Returns the rows checked, 0 when fewer than
    MIN_LIST_ROWS are left."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca

    rows = (~tile_over).repeat_interleave(LIST_TILE)[:n].nonzero().squeeze(1)
    listed = int((~tile_over).sum())
    if rows.numel() < MIN_LIST_ROWS:
        print(f"[7c] {n}-body {dim}-D float64 {tree}: {rows.numel()} rows in {listed} of "
              f"{tile_over.numel()} tiles went through the lists, under {MIN_LIST_ROWS}")
        return 0
    pick = torch.linspace(0, rows.numel() - 1, min(65536, rows.numel()), device=rows.device)
    rows = rows[pick.round().long()]
    ref = G * ca.allpairs_block_cuda(x[rows].contiguous(), m, x, eps_of(torch.float64),
                                     LIST_SOFTENING[tree])
    accuracy("7c", f"float64 {tree} list path vs {LIST_SOFTENING[tree]} all-pairs "
             f"({rows.numel()} rows of the {listed} of {tile_over.numel()} tiles evaluated "
             f"through the lists)", n, a[rows], ref, dim)
    return rows.numel()


def list_pairs_and_bytes(args, n: int):
    """The pairs a list evaluation needs (each tile's rows that are bodies,
    times the sources of its live heads with a nonzero mass), and its bytes
    (the rows, the live heads' entries and lengths read once, the output
    written once)."""
    import torch

    xi, mj, xj, _, _, split, n0, n1 = args
    ntiles, length = mj.shape
    tb = xi.shape[0] // ntiles
    lane = torch.arange(length, device=mj.device)
    heads = (lane < n0[:, None].long()) | ((lane >= split) & (lane < split + n1[:, None].long()))
    rows = (n - torch.arange(ntiles, device=mj.device) * tb).clamp(0, tb)
    pairs = int(((heads & (mj != 0)).sum(1) * rows).sum())
    size = xi.element_size()
    nbytes = (2 * xi.numel() * size + int(heads.sum()) * (xi.shape[1] + 1) * size
              + (n0.numel() + n1.numel()) * 4)
    return pairs, nbytes


def measure_list(tag: str, args, n: int, twin_budget_ms: float = 20e3) -> dict:
    """Time group_eval_kernel on recorded list args (5 launches after a
    warm-up, CUDA events) and its twin: on all tiles if the first 256
    tiles extrapolate to under twin_budget_ms, else on those 256. Holds the
    kernel against the twin within TOL of each row's sum of |term| and
    checks that two launches are bit-equal; counts its pairs, computes its
    bound and prints its DP floor (float64) or MUFU floor (float32)."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg

    xi, mj, xj, eps, softening, split, n0, n1 = args
    dtype = str(xi.dtype).split(".")[-1]
    ntiles, tb = mj.shape[0], xi.shape[0] // mj.shape[0]
    got = cg.group_eval_cuda(*args)  # warm-up launch
    again = cg.group_eval_cuda(*args)
    kms = event_ms(lambda: cg.group_eval_cuda(*args), reps=5)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    del again

    def twin_args(t1):
        return (xi[:t1 * tb], mj[:t1], xj[:t1], eps, softening, split, n0[:t1], n1[:t1])

    first = min(256, ntiles)
    first_ms, ref = event_ms(lambda: cg.group_eval_torch(*twin_args(first)), reps=1, keep=True)
    tiles, plain_ms = first, first_ms
    if first < ntiles and first_ms * ntiles / first <= twin_budget_ms:
        del ref
        tiles = ntiles
        plain_ms, ref = event_ms(lambda: cg.group_eval_torch(*twin_args(tiles)), reps=1, keep=True)
    scale = cg.group_eval_torch(*twin_args(tiles), absolute=True)
    err, abs_err = scaled(got[:tiles * tb], ref, scale)
    del ref, scale
    pairs, nbytes = list_pairs_and_bytes(args, n)
    flops = flops_per_pair(xi.shape[1], softening)
    bound_ms, bound_by = bound(pairs, flops, nbytes, F64_FLOPS if dtype == "float64" else F32_FLOPS)
    sms = ca.sm_count_of(xi.device.index)
    live = int(((n0 + n1) > 0).sum())
    P = cg.split_parts(ntiles, mj.shape[1], sms)
    if dtype == "float64":
        floor, floor_name = dp_floor_ms(pairs, xi.shape[1], softening, sms), "DP floor"
    else:
        floor, floor_name = mufu_floor_ms(pairs, sms), "MUFU floor"
    print(f"[{tag}] group_eval_kernel<{dtype}, {softening}>: {ntiles} tiles ({live} with live "
          f"heads), L = {mj.shape[1]} (split {split}), P = {P} parts a tile, "
          f"kernel {kms:.3f} ms, plain {plain_ms:.1f} ms "
          f"on {'all' if tiles == ntiles else 'the first'} {tiles} tiles; two launches "
          f"{'bit-equal' if same else 'DIFFER'}; max |kernel - plain| / sum|term| = {err:.3e} "
          f"(limit {TOL[dtype]:g}); {pairs} pairs ({pairs / (kms * 1e-3):.4e} pairs/s), bound "
          f"{bound_ms:.3f} ms ({bound_by}, {flops} FLOPs per pair), {floor_name} {floor:.3f} ms "
          f"({floor / kms:.3f} of it)")
    check(err <= TOL[dtype],
          f"{tag} group_eval_kernel: scaled error {err:.3e} above {TOL[dtype]:g}")
    check(same, f"{tag} group_eval_kernel: two launches on the same inputs differ")
    return {"ms": kms, "plain_ms": plain_ms, "plain_tiles": tiles, "max_abs_err": abs_err,
            "max_scaled_err": err, "scaled_err_limit": TOL[dtype], "pairs": pairs,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bit_equal_launches": same, "live_tiles": live, "parts_a_tile": P}


def list_phases(dev, big: int):
    """Phase 7: the trees' list paths at 2^20. Returns the JSON entries of
    group_eval_kernel (float64 and float32, sqrt3 and poly), the float64
    all-pairs kernel's fallback launches in the 3-D CLI runs, by tree, and
    the launch counts of the 3-D octree run."""
    import torch

    from nbody_torch import cli
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg

    measured, causes, checked = {}, {}, {}
    # -- (a) one float64 evaluation per tree and dimension, its list kernel
    #    call recorded (3-D) and its tiles' overflow causes printed;
    #    (c) the rows it evaluated through the lists against the exact sum
    for tree in LIST_SOFTENING:
        for dim in (3, 2):
            a, counters, G, (m, x), (args, every), tile_over, wall, peak = list_evaluation(
                tree, dev, big, dim)
            print(f"[7a] {big}-body {dim}-D float64 galaxy, one {tree} list-path force evaluation: "
                  f"{wall:.3f} s wall{' (first call)' if dim == 3 else ''}, peak memory above its "
                  f"inputs {peak:.2f} GiB; {counters}")
            check(bool(torch.isfinite(a).all()), f"{tree} {dim}-D list force is not finite")
            check(not bool(((args[6] + args[7]) > 0)[tile_over].any()),
                  f"7a {tree} {dim}-D: a tile of the exact fallback has live heads")
            causes[f"{tree}_{dim}d"] = {k: v for k, v in counters.items()
                                        if k.startswith("over_") or k == "fallback_tiles"}
            # (b) the CLI's work (the fallback's tiles skipped), (a) every tile's heads
            measured[(tree, dim)] = measure_list(f"7a {tree} {dim}-D CLI work", args, big)
            measured[(tree, dim)]["all_heads_live"] = measure_list(
                f"7a {tree} {dim}-D every head live", every, big)
            if (tree, dim) == ("octree", 3):
                _, nparts, P = launched_parts(lambda: cg.group_eval_cuda(*args))
                list_sum = parts_sum_extras("7a octree 3-D", nparts, P,
                                            args[0].shape[0] // nparts.shape[0], 3, args[0].dtype)
            del args, every
            checked[(tree, dim)] = list_accuracy(tree, big, dim, a, G, m, x, tile_over)
            del a, m, x, tile_over
            torch.cuda.empty_cache()
        if not checked[(tree, 3)]:  # every 3-D tile fell back: check 3-D at 2^18
            n18 = big >> 2
            a, counters, G, (m, x), _, tile_over, *_ = list_evaluation(tree, dev, n18, 3)
            print(f"[7a] {n18}-body 3-D float64 galaxy, {tree} list path: {counters}")
            checked[(tree, 3)] = list_accuracy(tree, n18, 3, a, G, m, x, tile_over)
            del a, m, x, tile_over
            torch.cuda.empty_cache()
        for dim in (3, 2):
            check(checked[(tree, dim)] >= MIN_LIST_ROWS,
                  f"7c {tree} {dim}-D: too few rows went through the lists to check")

    # the float32 instantiation, through the step functions' list branch:
    #  on the step's work and on every tile's heads (at 2^20 3-D nearly every
    #  tile falls back, so the step's call has few live tiles or none)
    f32 = {}
    for tree in LIST_SOFTENING:
        launches, args, every = list_step_float32(tree, dev, big)
        res = measure_list(f"7a {tree} float32 step's work", args, big)
        res["all_heads_live"] = measure_list(f"7a {tree} float32 every head live", every, big)
        live = (res["live_tiles"], res["all_heads_live"]["live_tiles"])
        print(f"[7a] float32 {tree}: live tiles on the step's work {live[0]}, on every head "
              f"{live[1]}")
        check(max(live) > 0, f"7a float32 {tree}: the list kernel was held on no live tile")
        f32[tree] = (launches, res)
        del args, every
        torch.cuda.empty_cache()

    # -- (b) the CLI at full size in double precision; counts from 0 just before;
    #    then probe trace of 2 steps, the list kernel's device time a step
    launches = {tree: cli_full_size(tree, 3, big, "7b", "double") for tree in LIST_SOFTENING}
    launches_2d = {tree: cli_full_size(tree, 2, big, "7b", "double")
                   for tree in LIST_SOFTENING}
    list_trace = {}
    for tree in LIST_SOFTENING:
        for dim in (3, 2):
            res = traced("7b", big, dim, tree, "double", steps=2)
            per_step = {k: v / res["steps"] * 1e3 for k, v in res["device_s_by_kernel"].items()
                        if "group_eval_kernel" in k or "parts_sum_kernel" in k}
            list_trace[(tree, dim)] = {"list_kernel_ms_a_step": per_step,
                                       **{k: res[k] for k in ("wall_s", "device_s", "idle_share")}}
            print(f"[7b] {tree} {dim}-D float64: the list kernel and its second pass a step "
                  f"(device ms, probe trace): {per_step}; idle share {res['idle_share']:.4f}")
            check(any("group_eval_kernel" in k for k in per_step),
                  f"7b {tree} {dim}-D: the trace shows no list kernel")
    group_keys = [k for k in cg.launch_counts if k.startswith("group_eval_kernel<")]
    for tree, softening in LIST_SOFTENING.items():
        key = cg.group_eval_name(torch.float64, softening)
        for run in (launches[tree], launches_2d[tree]):
            check(run[key] == 12 and sum(run[k] for k in group_keys) == 12,
                  f"the float64 {tree} run launched {({k: run[k] for k in group_keys})}, expected "
                  f"12 of {key} (one per step) and no other instantiation")
        key32 = cg.group_eval_name(torch.float32, softening)
        run = f32[tree][0]
        check(run[key32] == 1 and sum(run[k] for k in group_keys) == 1,
              f"the float32 {tree} list-path step launched {({k: run[k] for k in group_keys})}, "
              f"expected one {key32}")

    # -- (d) 17,000 bodies, 3-D, caps small enough that tiles fall back:
    #    the card against the CPU twins
    for tree in LIST_SOFTENING:
        runs = []
        for device in (dev, torch.device("cpu")):
            a, counters, *_ = list_evaluation(tree, device, 17000, 3, (LIST_CAPS, LIST_CAPS))
            runs.append((a.cpu(), counters))
        check(runs[1][1]["fallback_tiles"] > 0, f"7d {tree}: no tile fell back: {runs[1][1]}")
        card_vs_cpu("7d", f"17000-body 3-D float64 galaxy, {tree} list path, caps {LIST_CAPS}",
                    runs, TOL["float64"])

    # -- (e) the small path on the card and on the CPU: the same printed state
    for tree in LIST_SOFTENING:
        texts = {}
        for device in ("cuda", "cpu"):
            out = io.StringIO()
            cli.main(["-n", "64", "-s", "5", "--algorithm", tree, "--precision", "double",
                      "--print-state", "--device", device], out=out)
            texts[device] = [ln for ln in out.getvalue().splitlines()
                             if not ln.startswith("Total time:")]
        gpu, cpu = texts["cuda"], texts["cpu"]
        same_order = [NUM.sub("#", ln) for ln in gpu] == [NUM.sub("#", ln) for ln in cpu]
        gv, cv = (np.array([float(v) for v in NUM.findall("\n".join(t))]) for t in (gpu, cpu))
        rel = (float((np.abs(gv - cv) / np.maximum(np.abs(cv), 1e-300)).max()) if same_order
               else 1.0)
        print(f"[7e] -n 64 -s 5 --algorithm {tree} --precision double --print-state: card vs CPU "
              f"{len(gv)} printed values, body order {'the same' if same_order else 'DIFFERS'}, "
              f"max relative difference {rel:.3e} (limit 1e-12)")
        check(same_order and len(gv) > 0 and rel <= 1e-12, f"7e {tree}: printed states differ")

    entries = []
    for tree, softening in LIST_SOFTENING.items():
        key = cg.group_eval_name(torch.float64, softening)
        entries.append({"name": key, "route": "cuda", "source": GROUP_EVAL,
                        "replaces": f"{PALLAS_GROUP_EVAL}:83", "launches": launches[tree][key],
                        "launches_in": f"phase 7b: {big}-body 3-D {tree} --precision double "
                                       "--csv-total",
                        **measured[(tree, 3)], "n": big, "dim": 3, "dtype": "float64",
                        "timed_on": "the 7a call's inputs (the fallback's tiles skipped, as the "
                                    "CLI runs it); all_heads_live: every tile's heads",
                        "launches_2d": launches_2d[tree][key], "2d": measured[(tree, 2)],
                        "trace": {dim: list_trace[(tree, dim)] for dim in (3, 2)},
                        "overflow": {dim: causes[f"{tree}_{dim}d"] for dim in (3, 2)}})
    entries[0]["parts_sum_float64"] = {**list_sum, "launches": launches["octree"][PARTS_SUM],
                                       "timed_on": "random partial rows of the 7a 3-D octree "
                                                   "call's shape and part counts"}
    for tree, softening in LIST_SOFTENING.items():
        key = cg.group_eval_name(torch.float32, softening)
        entries.append({"name": key, "route": "cuda", "source": GROUP_EVAL,
                        "replaces": f"{PALLAS_GROUP_EVAL}:83", "launches": f32[tree][0][key],
                        "launches_in": f"phase 7a: {tree}_step_force(list_path=True) on a "
                                       f"{big}-body 3-D float32 galaxy",
                        **f32[tree][1], "n": big, "dim": 3, "dtype": "float32"})
    fallback = {tree: launches[tree][ca.NEWTON64] for tree in LIST_SOFTENING}
    return entries, fallback, launches["octree"]


PALLAS_ALLPAIRS = "nbody_tpu/ops/pallas_allpairs.py"
PALLAS_MXU = "nbody_tpu/ops/pallas_allpairs_mxu.py"
BF16_FLOPS = 989e12
MXU_FAST_TOL = 1e-4  # kernel vs twin under bf16 W and B (tests/test_torch_kernels.py)


def variant_calls(eps: float):
    """name -> (kernel call (m, x) -> (a, its per-i-tile branch counts or
    None), twin call (m, x, rows) -> the same for the i-tiles that hold the
    first `rows` rows (rows None: all), TPU kernel replaced, branch names,
    tolerance against the twin, kernel_bench name)."""
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_allpairs_mxu as cm

    mxu_fast = {"fast": True, "far_thresh": 1e-2}  # kernel_bench.py:63-64
    return {
        ca.EXACT: (lambda m, x: (ca.allpairs_accel_cuda(m, x, 1.0, eps, exact=True), None),
                   lambda m, x, rows: (ca.allpairs_block_torch(x[:rows], m, x, eps), None),
                   f"{PALLAS_ALLPAIRS}:113 (exact=True, :77-78)", None, TOL["float32"],
                   "exact"),
        ca.FAST: (lambda m, x: ca.allpairs_accel_cuda(m, x, 1.0, eps, exact=False, fast=True,
                                                      return_counts=True),
                  lambda m, x, rows: ca.allpairs_fast_torch(m, x, 1.0, eps, rows=rows),
                  f"{PALLAS_ALLPAIRS}:113 (fast=True, :93-105)", ("softened", "far"),
                  TOL["float32"], "fast"),
        cm.PLAIN: (lambda m, x: cm.allpairs_accel_mxu_cuda(m, x, 1.0, eps, return_counts=True),
                   lambda m, x, rows: cm.allpairs_accel_mxu_torch(m, x, 1.0, eps, rows=rows),
                   f"{PALLAS_MXU}:207", cm.BRANCHES, TOL["float32"], "mxu"),
        cm.FAST: (lambda m, x: cm.allpairs_accel_mxu_cuda(m, x, 1.0, eps, return_counts=True,
                                                          **mxu_fast),
                  lambda m, x, rows: cm.allpairs_accel_mxu_torch(m, x, 1.0, eps, rows=rows,
                                                                 **mxu_fast),
                  f"{PALLAS_MXU}:207 (fast=True)", cm.BRANCHES, MXU_FAST_TOL, "mxu-fast"),
    }


def sorted_bodies(m, x, eps: float):
    """(m, x) in the order of the quirk Hilbert curve over their box, as
    bench.py:74-77 sorts its all-pairs bodies."""
    from nbody_torch.ops.geometry import aabb_of_points
    from nbody_torch.ops.hilbert import hilbert_sort_perm

    perm = hilbert_sort_perm(x, *aabb_of_points(x, eps))
    return m[perm].contiguous(), x[perm].contiguous()


def shares(names, counts) -> str:
    total = sum(counts)
    return ", ".join(f"{k} {c} ({c / total:.4f})" for k, c in zip(names, counts))


def variant_bound(name: str, counts, tile: int, n: int, dim: int, sms: int):
    """(bound ms, what bounds it, the FP32 and tensor-core times, the MUFU
    floor) of one evaluation of n bodies. Pairs by branch: each tile pair's
    tile * tile (no padding at n = 2^20). Newton and the fast variant's two
    chains count 5 dim + 3 operations a pair (flops_per_pair). The MXU
    kernel's FP32 chain: near pairs the exact chain with the Newton step
    (5 dim + 3, plus 3); far pairs the quadratic form, the square root, d2
    sqrt + eps, the reciprocal and its Newton step and the split (2 dim +
    10); far-fast pairs the form, the rsqrt, its cube and the rounding (2
    dim + 5). Its tensor cores: the m16n8k16 MMAs as issued, 2 * 16 * 8 *
    16 FLOPs per 16 x 16 pair slots, three in the far branch and one in
    far-fast, over 989 TFLOP/s bf16. Bytes: positions and masses read once,
    the accelerations written. The MUFU floor (worked out, kept out of
    bound_ms): one multi-function-unit operation a far pair of the fast
    variant and a far-fast pair of the MXU kernel (an rsqrt), two every
    other pair (a root and a reciprocal), at MUFU_PER_SM_CLOCK a clock on
    each SM at the boost clock."""
    nbytes = n * 4 * (dim + 1) + n * 4 * dim
    rate = sms * MUFU_PER_SM_CLOCK * MAX_SM_CLOCK_HZ / 1e3  # MUFU operations a ms
    if counts is None or name.startswith("allpairs_block_kernel"):
        bound_ms, by = bound(n * (n - 1), flops_per_pair(dim, "poly"), nbytes)
        mufu = (2 * n * (n - 1) if counts is None
                else (2 * counts[0] + counts[1]) * tile)  # fast: [softened, far]
        return bound_ms, by, bound_ms, 0.0, mufu / rate
    near, far, far_fast = (c * tile for c in counts)  # pairs
    fp32 = near * (5 * dim + 6) + far * (2 * dim + 10) + far_fast * (2 * dim + 5)
    mma = (far * 3 + far_fast) * 2 * 16 * 8 * 16 / 256
    t32, tmma = fp32 / F32_FLOPS * 1e3, mma / BF16_FLOPS * 1e3
    tbytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t32, tmma, tbytes)
    by = "bytes" if bound_ms == tbytes else "operations"
    return bound_ms, by, t32, tmma, (2 * near + 2 * far + far_fast) / rate


TILE_DECIDE = "nbody_torch/csrc/tile_decide.cu"
DECIDE_REPLACES = {  # the branch that each variant's TPU kernel decides inside its body
    "fast": f"{PALLAS_ALLPAIRS}:96-105 (the branch, inside _allpairs_kernel; no kernel of "
            f"its own)",
    "mxu": f"{PALLAS_MXU}:106-133 (the branch, inside _mxu_kernel; no kernel of its own)",
    "mxu-fast": f"{PALLAS_MXU}:106-133, 186-199 (the branches, inside _mxu_kernel; no kernel "
                f"of its own)",
}


def decision_modes(eps: float, n: int, dim: int, tiles=None) -> dict:
    """mode -> (npad, tile_i, tile_j, near_coef, thresh) of each variant's
    decision as its wrapper makes it (kernel_bench's mxu-fast far_thresh),
    on the variants' default tiles or on `tiles` (tile_i, tile_j)."""
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_allpairs_mxu as cm

    near_coef = float(np.float32(1e5 * eps))
    ti, tj = tiles or (512, 2048)
    npad_f, tj_f = ca.fast_tiling(n, dim, ti, tj)
    ti_m, tj_m = tiles or (512, 1024)
    npad_m = cm.mxu_padding(n, ti_m, tj_m)
    return {"fast": (npad_f, ti, tj_f, near_coef, ca.far_threshold(eps)),
            "mxu": (npad_m, ti_m, tj_m, near_coef, 0.0),
            "mxu-fast": (npad_m, ti_m, tj_m, near_coef, 1e-2)}


def decision_check(tag: str, x, what: str, modes: dict, itiles=None) -> dict:
    """The decision kernels against their plain versions on x, per mode:
    tile_stats_kernel's statistics equal tile_stats_torch's; the table
    bit-equal to decide_torch's on every i-tile (or on `itiles`); the
    exact pass taken by as many tile pairs as the box tests' mirror
    (box_table_torch) leaves open, and the mirror's settled branches equal
    to the table's. Prints the exact pass's share of the tile pairs and its
    pairs. Returns mode -> {opened, tile_pairs, exact_pairs, plain_ms,
    plain_itiles, max_abs_err}."""
    import torch

    from nbody_torch.ops import cuda_variant_decide as vd

    out = {}
    for mode, (npad, ti, tj, nc, th) in modes.items():
        table, stats, work = vd.decide_cuda(x, mode, npad, ti, tj, nc, th, work=True)
        rows = list(range(npad // ti)) if itiles is None else list(itiles)
        plain_ms, plain = event_ms(
            lambda: vd.decide_torch(x, mode, npad, ti, tj, nc, th, itiles=rows), 1, keep=True)
        plain_stats = vd.tile_stats_torch(x, npad, ti, tj, means=mode != "fast")
        boxes = vd.box_table_torch(plain_stats, npad // ti, npad // tj, mode, nc, th)
        settled = boxes >= 0
        opened, pairs = (int(v) for v in work.sum(0).tolist())
        err = (table[rows].float() - plain.float()).abs().max().item()
        same = err == 0 and torch.equal(stats, plain_stats)
        mirrored = opened == int((~settled).sum()) and torch.equal(boxes[settled], table[settled])
        print(f"[{tag}] decision {mode}, {what}: table {'bit-equal to' if same else 'DIFFERS from'}"
              f" its plain version on {len(rows)} of {npad // ti} i-tiles (statistics too); "
              f"exact pass on {opened} of {table.numel()} tile pairs ({opened / table.numel():.4f}"
              f", the box mirror's {'count' if mirrored else 'count DIFFERS'}), {pairs} pairs; "
              f"branches {vd.branch_counts(table, 3).sum(0).tolist()}")
        check(same, f"{tag} decision {mode} {what}: the table differs from its plain version")
        check(mirrored, f"{tag} decision {mode} {what}: the exact pass is not the boxes' open set")
        out[mode] = {"opened": opened, "tile_pairs": table.numel(), "exact_pairs": pairs,
                     "plain_ms": plain_ms, "plain_itiles": len(rows), "max_abs_err": err}
    return out


def decision_bound(mode: str, n: int, dim: int, ni: int, nj: int, exact_pairs: int):
    """(bound ms, what bounds it) of one table: the positions read once and
    the table written once over HBM, against the box tests (6 dim + 1
    operations a tile pair; MXU 18 dim + 6 with the frame, the z bounds and
    the margin) and this run's exact-pass pairs (3 dim a pair; MXU 2 dim + 3)
    over 67 TFLOP/s."""
    nbytes = n * dim * 4 + ni * nj
    per_tile = 6 * dim + 1 if mode == "fast" else 18 * dim + 6
    per_pair = 3 * dim if mode == "fast" else 2 * dim + 3
    return bound(1, ni * nj * per_tile + exact_pairs * per_pair, nbytes)


def straddle_check(dev, eps: float) -> None:
    """8a on cuda_variant_decide.straddle_layouts: two tiles of 64 bodies a
    few ulps either side of each threshold (far_thresh of fast and of
    mxu-fast, the near limit; the fast variant's also with a box looser than
    its bodies): the tables bit-equal to their plain version, both branches
    among them, and each variant at tiles (64, 64) against its twin with
    the same branch counts."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_allpairs_mxu as cm
    from nbody_torch.ops import cuda_variant_decide as vd

    for kind in vd.STRADDLES:
        mode = "fast" if kind.startswith("fast") else kind
        for dim in (2, 3):
            modes = {mode: decision_modes(eps, 128, dim, (64, 64))[mode]}
            _, _, _, nc, th = modes[mode]
            branches, worst = set(), 0.0
            for v, x in vd.straddle_layouts(kind, dim, nc, th):
                x = x.to(dev)
                m = torch.ones(128, device=dev)
                with contextlib.redirect_stdout(io.StringIO()):
                    decision_check("8a", x, f"{kind} v={v!r}", modes)
                if mode == "fast":
                    got, kc = ca.allpairs_accel_cuda(m, x, 1.0, eps, fast=True, tile_i=64,
                                                     tile_j=64, return_counts=True)
                    ref, tc = ca.allpairs_fast_torch(m, x, 1.0, eps, tile_i=64, tile_j=64)
                else:
                    kw = {"fast": True, "far_thresh": th} if mode == "mxu-fast" else {}
                    got, kc = cm.allpairs_accel_mxu_cuda(m, x, 1.0, eps, 64, 64,
                                                         return_counts=True, **kw)
                    ref, tc = cm.allpairs_accel_mxu_torch(m, x, 1.0, eps, 64, 64, **kw)
                check(kc.cpu().tolist() == tc.tolist(),
                      f"8a straddle {kind} {dim}-D v={v!r}: branch counts differ from the twin")
                err, _ = scaled(got, ref, ca.allpairs_block_abs_torch(x, m, x, eps))
                worst = max(worst, err)
                check(err <= (MXU_FAST_TOL if mode == "mxu-fast" else TOL["float32"]),
                      f"8a straddle {kind} {dim}-D v={v!r}: scaled error {err:.3e}")
                branches.add(tuple(kc[0].tolist()))  # i-tile A's counts: (A, B) flips
            print(f"[8a] straddling {kind} ({vd.STRADDLES[kind][1]}), {dim}-D: 9 layouts, "
                  f"tables bit-equal to their plain version, branch counts equal to the twin's, "
                  f"max scaled error {worst:.3e}, both branches {'seen' if len(branches) == 2 else 'NOT seen'}")
            check(len(branches) == 2, f"8a straddle {kind} {dim}-D: one branch only")


def variant_phases(dev, big: int):
    """Phase 8: the all-pairs variants. Returns their JSON entries."""
    import torch

    from nbody_torch import kernel_bench as kb
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_variant_decide as vd

    eps = eps_of(torch.float32)
    calls = variant_calls(eps)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def against_twin(tag, m, x, what, rows=None):
        """Each kernel against its twin on the first `rows` rows (whole
        i-tiles; None: all): the same branch on every tile pair of those
        i-tiles, and the sums within the tolerance. Returns name -> (kernel
        output, its tile pairs by branch over the whole run or None, scaled
        error, max abs error, twin ms)."""
        scale = ca.allpairs_block_abs_torch(x[:rows], m, x, eps)
        out = {}
        for name, (kern, twin, _, branches, tol, _) in calls.items():
            got, kc = kern(m, x)
            twin_ms, (ref, tc) = event_ms(lambda: twin(m, x, rows), reps=1, keep=True)
            err, abs_err = scaled(got[:rows], ref, scale)
            line = (f"[{tag}] {name}, {what}: max |kernel - plain| / sum|term| = {err:.3e} "
                    f"(limit {tol:g})" + (f" on the first {rows} rows" if rows else ""))
            totals = None
            if branches is not None:
                kc = kc.cpu()
                totals = kc.sum(0).tolist()
                same = kc[:tc.shape[0]].tolist() == tc.tolist()
                line += (f"; tile pairs {shares(branches, totals)}; the branch of every tile "
                         f"pair of the plain version's {tc.shape[0]} i-tiles "
                         f"{'the same' if same else 'DIFFERS'}")
                check(same, f"{tag} {name} {what}: branches differ on the plain version's i-tiles")
            print(line)
            check(err <= tol, f"{tag} {name} {what}: scaled error {err:.3e} above {tol:g}")
            out[name] = (got, totals, err, abs_err, twin_ms)
        del scale
        return out

    # -- (a) each kernel against its twin at 65,536 (and a ragged n) ----------
    def layouts(n, dim):
        rng = np.random.default_rng(SEED + dim)
        m = torch.tensor(rng.uniform(0.1, 1.0, n), dtype=torch.float32, device=dev)
        x = torch.tensor(rng.uniform(-1.0, 1.0, (n, dim)), dtype=torch.float32, device=dev)
        yield "uniform unsorted", m, x
        yield "uniform Hilbert-sorted", *sorted_bodies(m, x, eps)
        mc, xc = clusters(n, dim)
        yield "clusters Hilbert-sorted", *sorted_bodies(torch.tensor(mc, device=dev),
                                                        torch.tensor(xc, device=dev), eps)

    n = 65536
    for dim in (2, 3):
        for what, m, x in layouts(n, dim):
            against_twin("8a", m, x, f"{n} {dim}-D {what}")
            decision_check("8a", x, f"{n} {dim}-D {what}", decision_modes(eps, n, dim))
    mc, xc = clusters(n + 37, 3)
    m, x = sorted_bodies(torch.tensor(mc, device=dev), torch.tensor(xc, device=dev), eps)
    against_twin("8a", m, x, f"{n + 37} 3-D clusters Hilbert-sorted (ragged)")
    decision_check("8a", x, f"{n + 37} 3-D clusters Hilbert-sorted (ragged)",
                   decision_modes(eps, n + 37, 3))
    straddle_check(dev, eps)
    torch.cuda.empty_cache()

    # -- (b) 2^20 bodies, 2-D and 3-D, on kernel_bench's inputs unsorted (as the
    #    main path runs them: every tile pair near) and Hilbert-sorted (bench.py's
    #    all-pairs bodies: the far branches run), against the twins on the first
    #    8,192 rows; 3-D sorted also timed. (c) each against the float64 kernel on
    #    4,096 sampled rows, with the bounds of nbody_tpu's tests.
    rows = 8192
    idx = torch.tensor(np.sort(np.random.default_rng(SEED).choice(big, 4096, replace=False)),
                       device=dev)
    measured, checked = {}, {name: [] for name in calls}
    decided = {}
    for dim in (3, 2):
        m_np, x_np = kb.inputs(big, dim)
        m0, x0 = torch.tensor(m_np, device=dev), torch.tensor(x_np, device=dev)
        for order in ("Hilbert-sorted", "unsorted"):
            m, x = sorted_bodies(m0, x0, eps) if order == "Hilbert-sorted" else (m0, x0)
            what = f"{big}-body {dim}-D float32, kernel_bench's inputs {order}"
            res = against_twin("8b", m, x, what, rows)
            modes = decision_modes(eps, big, dim)
            sample = {mode: sorted({int(i) for i in np.linspace(0, npad // ti - 1, 16)})
                      for mode, (npad, ti, *_) in modes.items()}
            dec = {mode: decision_check("8b", x, what, {mode: modes[mode]}, sample[mode])[mode]
                   for mode in modes}
            a64 = ca.allpairs_block_cuda(x[idx].double(), m.double(), x.double(), eps)
            oracle = a64.norm(dim=1) + a64.abs().max() * 1e-3

            def oracle_err(a):
                return ((a[idx].double() - a64).norm(dim=1) / oracle).max().item()

            a_exact = res[ca.EXACT][0]
            err32 = oracle_err(a_exact)
            for name, limit, how in (
                (ca.EXACT, 1e-5, "max |a - a64| / max |a64|"),
                (ca.FAST, 1e-5, "max |a - a64| / max |a64|"),
                ("allpairs_mxu_kernel<float32>", max(4 * err32, 6e-5), "oracle error"),
                ("allpairs_mxu_kernel<float32, fast>", 5e-3, "oracle error"),
            ):
                got = res[name][0]
                err = (((got[idx].double() - a64).abs().max() / a64.abs().max()).item()
                       if how.startswith("max") else oracle_err(got))
                print(f"[8c] {name}, {what}, vs the float64 kernel on 4096 rows: {how} "
                      f"{err:.3e} (limit {limit:.3e}; the exact float32 kernel's oracle error "
                      f"{err32:.3e})")
                check(err <= limit, f"8c {name} {what}: {err:.3e} above {limit:.3e}")
                _, totals, serr, _, _ = res[name]
                branches = calls[name][3]
                checked[name].append({"dim": dim, "inputs": order, "max_scaled_err": serr,
                                      "tile_pairs": dict(zip(branches, totals)) if totals else None,
                                      "accuracy_vs_float64": err, "accuracy_limit": limit})
            if dim == 3 and order == "Hilbert-sorted":
                newton_ms = event_ms(lambda: ca.allpairs_accel_cuda(m, x, 1.0, eps), reps=3)
                for name, (_, _, replaces, branches, tol, label) in calls.items():
                    accel = kb.accel_fn(label, eps)  # kernel_bench's call, without counts
                    ms = event_ms(lambda: accel(m, x), reps=3)
                    _, totals, err, abs_err, twin_ms = res[name]
                    bound_ms, by, t32, tmma, mufu = variant_bound(name, totals, 512 * 1024, big,
                                                                  3, sms)
                    print(f"[8b] {name} ({label}), {what}: call {ms:.1f} ms, its decision "
                          f"included where it has one (the CLI's Newton kernel {newton_ms:.1f} "
                          f"ms); plain version {twin_ms:.1f} ms on its first {rows} rows (not "
                          f"extrapolated); bound {bound_ms:.3f} ms ({by}; FP32 chain "
                          f"{t32:.3f} ms, tensor cores {tmma:.3f} ms); MUFU floor {mufu:.3f} ms "
                          f"({ms and mufu / ms:.3f} of the call)")
                    measured[name] = {"ms": ms, "plain_ms": twin_ms, "plain_rows": rows,
                                      "max_abs_err": abs_err, "max_scaled_err": err,
                                      "scaled_err_limit": tol, "bound_ms": bound_ms,
                                      "bound_by": by, "library_ms": None,
                                      "bound_fp32_ms": t32, "bound_tensor_core_ms": tmma,
                                      "newton_kernel_ms": newton_ms,
                                      "replaces": replaces,
                                      "tile_pairs": dict(zip(branches, totals)) if totals else None}
                stats_modes = {"fast": False, "mxu": True}
                for mode, (npad, ti, tj, nc, th) in modes.items():
                    st = vd.tile_stats_cuda(x, npad, ti, tj, means=mode != "fast")
                    table_ms = event_ms(lambda: vd.table_cuda(x, st, mode, npad, ti, tj, nc, th),
                                        reps=5)
                    d = dec[mode]
                    bound_ms, by = decision_bound(mode, big, 3, npad // ti, npad // tj,
                                                  d["exact_pairs"])
                    print(f"[8b] {vd.DECIDE[mode]}, {what}: {table_ms:.3f} ms (its statistics "
                          f"apart); exact pass on {d['opened']} of {d['tile_pairs']} tile pairs "
                          f"({d['opened'] / d['tile_pairs']:.4f}), {d['exact_pairs']} pairs; bound "
                          f"{bound_ms:.3f} ms ({by}); plain version {d['plain_ms']:.1f} ms on "
                          f"{d['plain_itiles']} i-tiles")
                    decided[vd.DECIDE[mode]] = {
                        "ms": table_ms, "plain_ms": d["plain_ms"],
                        "plain_itiles": d["plain_itiles"], "max_abs_err": d["max_abs_err"],
                        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                        "replaces": DECIDE_REPLACES[mode], "exact_pass_tile_pairs": d["opened"],
                        "tile_pairs": d["tile_pairs"], "exact_pass_pairs": d["exact_pairs"]}
                for mode, means in stats_modes.items():
                    npad, ti, tj = modes[mode][:3]
                    stats_ms = event_ms(lambda: vd.tile_stats_cuda(x, npad, ti, tj, means), reps=10)
                    plain_ms, plain = event_ms(
                        lambda: vd.tile_stats_torch(x, npad, ti, tj, means), 1, keep=True)
                    err = (vd.tile_stats_cuda(x, npad, ti, tj, means) - plain).abs().max().item()
                    bound_ms, by = bound(1, 0, big * 3 * 4 + plain.numel() * 4)
                    which = "boxes and means, the MXU tiles" if means else "boxes, the fast tiles"
                    print(f"[8b] {vd.STATS} ({which}), {what}: {stats_ms:.4f} ms, plain version "
                          f"{plain_ms:.3f} ms, max |kernel - plain| {err:g}; bound {bound_ms:.4f} "
                          f"ms ({by})")
                    check(err == 0, f"8b {vd.STATS}: differs from its plain version")
                    if means:
                        decided[vd.STATS] = {
                            "ms": stats_ms, "plain_ms": plain_ms, "max_abs_err": err,
                            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                            "replaces": f"{PALLAS_MXU}:103-108 (the tiles' means, inside "
                                        f"_mxu_kernel); {PALLAS_ALLPAIRS}:96 (the minimum's "
                                        f"operands): no kernel of its own"}
            del res, a64, oracle, a_exact, m, x
            torch.cuda.empty_cache()
        del m0, x0

    # -- (d) python -m nbody_torch.kernel_bench at 2^18, as a subprocess ------
    cmd = [sys.executable, "-m", "nbody_torch.kernel_bench", "--n", "262144", "--dims", "2,3",
           "--kernels", "newton,exact,fast,mxu,mxu-fast", "--repeats", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    rows_out = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    print(f"[8d] {' '.join(cmd[1:])}: rc {proc.returncode}, {len(rows_out)} lines in "
          f"{time.perf_counter() - t0:.0f} s")
    for r in rows_out:
        print(f"[8d]   {json.dumps(r)}")
    check(proc.returncode == 0 and len(rows_out) == 10,
          f"kernel_bench failed: {proc.stderr[-2000:]}")
    launches = {}
    for r in rows_out:
        check({"kernel", "dim", "n", "sec_per_step", "int_per_s"} <= set(r), f"keys of {r}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    entries = []
    sources = {ca.EXACT: "nbody_torch/csrc/allpairs.cu", ca.FAST: "nbody_torch/csrc/allpairs.cu"}
    for name in calls:
        check(launches.get(name, 0) > 0, f"{name} was not launched by kernel_bench")
        entries.append({"name": name, "route": "cuda",
                        "source": sources.get(name, "nbody_torch/csrc/allpairs_mxu.cu"),
                        "launches": launches[name],
                        "launches_in": "phase 8d: python -m nbody_torch.kernel_bench --n 262144 "
                                       "--dims 2,3 --repeats 1",
                        **measured[name], "n": big, "dim": 3, "dtype": "float32",
                        "inputs": "kernel_bench's inputs Hilbert-sorted (bench.py's all-pairs "
                                  "bodies)",
                        "checked_at_2p20": checked[name]})
    for name, fields in decided.items():
        check(launches.get(name, 0) > 0, f"{name} was not launched by kernel_bench")
        entries.append({"name": name, "route": "cuda", "source": TILE_DECIDE,
                        "launches": launches[name],
                        "launches_in": "phase 8d: python -m nbody_torch.kernel_bench --n 262144 "
                                       "--dims 2,3 --repeats 1 (one a fast, mxu or mxu-fast "
                                       "evaluation)",
                        **fields, "n": big, "dim": 3, "dtype": "float32",
                        "inputs": "kernel_bench's inputs Hilbert-sorted (bench.py's all-pairs "
                                  "bodies)"})
    return entries


ABLATE_KERNELS = {  # name -> (wrapper in ops.cuda_group_eval, twin, its keyword args, TPU kernel)
    "masked_eval_kernel": ("masked_eval_cuda", "masked_eval_torch", {},
                           f"{PALLAS_GROUP_EVAL}:216"),
    "group_shared_masked_kernel": ("group_shared_masked_eval_cuda",
                                   "group_shared_masked_eval_torch", {},
                                   f"{PALLAS_GROUP_EVAL}:717"),
    "entries_lohi_kernel<packed>": ("entries_lohi_eval_cuda", "entries_lohi_eval_torch",
                                    {"packed": True}, f"{PALLAS_GROUP_EVAL}:896"),
}
# the tokens of each tree, and the kernel each one brings
OCTREE_TOKENS = {"densemask": "masked_eval_kernel", "farcompact": "group_shared_masked_kernel",
                 "packedj": "entries_lohi_kernel<packed>", "desc1": "group_shared_masked_kernel",
                 "desc2": "group_shared_masked_kernel"}
BVH_TOKENS = {"densemask": "masked_eval_kernel", "packedj": "entries_lohi_kernel<packed>"}
HEAD_TILES = 256  # 9a: the plain version on the first 256 tiles when all would take over 20 s


def head_args(name: str, args, tiles: int):
    """A kernel's recorded args cut to its first `tiles` row tiles, and
    their rows."""
    import torch

    xi = args[0]
    if name == "masked_eval_kernel":
        tb = xi.shape[0] // args[3].shape[0]
        return (xi[:tiles * tb], *args[1:3], args[3][:tiles], *args[4:]), tiles * tb
    if name == "group_shared_masked_kernel":
        tb, G = xi.shape[0] // args[3].shape[0], args[5]
        lists = -(-tiles // G)
        return (xi[:tiles * tb], args[1][:lists], args[2][:lists], args[3][:tiles],
                *args[4:]), tiles * tb
    ent, n_real, ntiles = args[3], int(args[5]), args[7]  # entries: tile-sorted
    tb = xi.shape[0] // ntiles
    n_head = int(((ent[:n_real] >> 16) < tiles).sum())
    return (xi[:tiles * tb], *args[1:5], torch.tensor(n_head, device=xi.device), args[6], tiles,
            *args[8:]), tiles * tb


def ablate_pairs(name: str, args) -> int:
    """The pairs a kernel of the ablation path needs: set mask entries of
    nonzero mass times the rows (the dense-mask far field, the shared
    lists); for the packed entries sum(hi - lo) of live bodies times the
    rows (pairs_of)."""
    import torch

    if name == "entries_lohi_kernel<packed>":
        return pairs_of("entries_lohi_kernel", args)
    xi, mj, mask = args[0], args[1], args[3]
    if name == "group_shared_masked_kernel":  # tile t's list: t // G
        mj = mj[torch.arange(mask.shape[0], device=mask.device) // args[5]]
    return int(((mask * mj) != 0).sum()) * (xi.shape[0] // mask.shape[0])


def measure_ablate(tag: str, name: str, args, dim: int, softening: str) -> dict:
    """measure_kernel on an ablation kernel's recorded args, its plain
    version checked on the first HEAD_TILES tiles and timed on all tiles
    where those extrapolate to under 20 s."""
    from nbody_torch.ops import cuda_group_eval as cg

    attr, twin_attr, kw, _ = ABLATE_KERNELS[name]
    kern, twin = getattr(cg, attr), getattr(cg, twin_attr)
    ntiles = args[7] if name == "entries_lohi_kernel<packed>" else args[3].shape[0]
    t_args, rows = head_args(name, args, min(HEAD_TILES, ntiles))
    return measure_kernel(
        tag, f"{name}<{softening}>", lambda: kern(*args, **kw),
        lambda conv, absolute: twin(*conv(t_args), absolute=absolute, **kw),
        ablate_pairs(name, args), flops_per_pair(dim, softening), bytes_of(args), rows=rows,
        plain_all=lambda: twin(*args, **kw))


def ablate_eval(tree: str, dev, bodies, depth: int, token: str, knobs, **kw):
    """One fast-path force evaluation with `ablate` token ("" the default
    path) of the sorted bodies: (ms, xs, keys) for the octree, (m, x) for
    the BVH; knobs (theta, G, eps). Returns (G * accel, its counters as
    ints, the ablation kernels' recorded calls as wrapper -> (args,
    kwargs))."""
    import torch

    from nbody_torch.ops import bvh, bvh_group, octree_group

    theta, G, eps = knobs
    wrappers = ["masked_eval_cuda", "group_shared_masked_eval_cuda", "entries_lohi_eval_cuda"]
    module = octree_group if tree == "octree" else bvh_group
    with recording(module, [w for w in wrappers if hasattr(module, w)]) as rec:
        if tree == "octree":
            a, info = octree_group.compute_force_grouped_fast(*bodies, depth, theta, G, eps,
                                                              ablate=token, **kw)
        else:
            m, x = bodies
            a, info = bvh_group.compute_force_grouped_windowed(bvh.build_tree(m, x, eps), m, x,
                                                               theta, G, eps, ablate=token, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return a, {k: int(v) for k, v in info.items()}, {k: (v, rec.kwargs[k]) for k, v in rec.items()}


def ablation_phases(dev, big: int, sass_job):
    """Phase 9: the ablation path. Returns the JSON entries of its three
    kernels (sass_job: start_sass's future of group_eval.cu)."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh, octree
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.state import SystemState

    t9 = time.perf_counter()
    eps = eps_of(torch.float32)
    measured = {name: {} for name in ABLATE_KERNELS}
    kernel_wrapper = {name: attr for name, (attr, *_) in ABLATE_KERNELS.items()}

    # -- (a) one force evaluation of a 2^20 galaxy per tree, dimension and
    #    token, the new kernels' calls recorded and re-run, timed beside
    #    their plain versions; (b) the checks on the card
    for tree, tokens in (("octree", OCTREE_TOKENS), ("bvh", BVH_TOKENS)):
        softening = "sqrt3" if tree == "octree" else "poly"
        for dim in (3, 2):
            cfg, state = build_model("galaxy", big, dim, np.float32, device=dev)
            knobs = (cfg.theta, cfg.G, cfg.eps)
            depth = 0
            if tree == "octree":
                depth = octree.max_depth(big, dim)
                lo, hi = octree.robust_quant_box(state.x)
                bodies = octree.morton_sort(state.m, state.x, lo, hi, depth)[:3]
            else:
                st = bvh.hilbert_sort(state, cfg.eps)
                bodies = (st.m, st.x)
                del st
            del state
            a0 = ablate_eval(tree, dev, bodies, depth, "", knobs)[0]
            # the octree's heap sums masses and moments with index_add_, whose
            # CUDA atomics add in no fixed order: two runs of the same path
            # may differ in the last bits of a centre of mass
            again = ablate_eval(tree, dev, bodies, depth, "", knobs)[0]
            repeatable = torch.equal(a0, again)
            print(f"[9b] {tree} {dim}-D default path run twice: "
                  f"{'bit-equal' if repeatable else 'not bit-equal'}, sum|diff| / sum|a| = "
                  f"{((again - a0).abs().sum() / a0.abs().sum()).item():.3e}")
            check(repeatable or tree == "octree", "the BVH fast path is not repeatable")
            del again
            ref = None
            for token, name in tokens.items():
                t0 = time.perf_counter()
                a, info, rec = ablate_eval(tree, dev, bodies, depth, token, knobs)
                wall = time.perf_counter() - t0
                print(f"[9a] {big}-body {dim}-D galaxy, {tree} ablate={token}: {wall:.3f} s wall; "
                      f"{info}")
                check(bool(torch.isfinite(a).all()), f"{tree} {token} force is not finite")
                args, kwargs = rec[kernel_wrapper[name]]
                check(kwargs.get("packed", False) == (name == "entries_lohi_kernel<packed>"),
                      f"{tree} {token}: the recorded entries call is not the packed one")
                tag = f"9a {dim}-D {tree} {token}"
                entry = measure_ablate(tag, name, args, dim, softening)
                if name != "entries_lohi_kernel<packed>":  # the two weighted far fields
                    entry.update(far_extras(tag, name, getattr(cg, kernel_wrapper[name]), args,
                                            (args[3] != 0).sum(1), softening, entry["pairs"],
                                            sass_job))
                measured[name][f"{tree}_{token}_{dim}d"] = entry
                # (b) correctness on the card
                rel = ((a - a0).abs().sum() / a0.abs().sum()).item()
                if token == "packedj":
                    # the packed kernel on the recorded entries against the
                    # unpacked one on the same inputs: bit for bit; the forces
                    # against the default path's: bit for bit where the path
                    # repeats, else within 1e-6 of sum |a|
                    packed = cg.entries_lohi_eval_cuda(*args, packed=True)
                    same_kernel = torch.equal(packed, cg.entries_lohi_eval_cuda(*args))
                    same = torch.equal(a, a0)
                    print(f"[9b] {tree} {dim}-D packedj: the packed entries kernel vs the unpacked "
                          f"one on the same entries {'bit-equal' if same_kernel else 'DIFFER'}; "
                          f"forces vs the default path {'bit-equal' if same else 'not bit-equal'}, "
                          f"sum|diff| / sum|a| = {rel:.3e}")
                    check(same_kernel, f"{tree} {dim}-D: the packed entries kernel differs from "
                          "the unpacked one")
                    check(same if repeatable else rel <= 1e-6,
                          f"{tree} {dim}-D packedj forces differ from the default path's")
                    del packed
                elif token == "densemask":
                    xi, mj, xj, mask = args[:4]
                    far = cg.masked_eval_cuda(*args)
                    bits = cg.masked_eval_bits_cuda(xi, mj, xj, cg.pack_mask_bits(mask != 0), eps,
                                                    softening)
                    t_args, rows = head_args(name, args, HEAD_TILES)
                    err = scaled(far[:rows], bits[:rows], cg.masked_eval_torch(*t_args,
                                                                               absolute=True))[0]
                    print(f"[9b] {tree} {dim}-D densemask far field vs the bit-packed far field on "
                          f"the same accepts, first {HEAD_TILES} tiles: max |diff| / sum|term| = "
                          f"{err:.3e} (limit 1e-5); forces vs the default path: sum|diff| / "
                          f"sum|a| = {rel:.3e}")
                    check(err <= 1e-5, f"{tree} {dim}-D densemask far field differs from the "
                          "bit-packed one")
                    del far, bits, t_args
                elif token == "farcompact":
                    # the shared-list kernel under poly too (no path runs it),
                    # on the recorded lists, against its plain version
                    poly_args = (*args[:6], "poly")
                    poly = cg.group_shared_masked_eval_cuda(*poly_args)
                    t_args, rows = head_args(name, poly_args, HEAD_TILES)
                    poly_err = scaled(poly[:rows], cg.group_shared_masked_eval_torch(*t_args),
                                      cg.group_shared_masked_eval_torch(*t_args, absolute=True))[0]
                    print(f"[9b] octree {dim}-D farcompact vs the default path: sum|diff| / "
                          f"sum|a| = {rel:.3e} (limit 1e-5); far_over tiles "
                          f"{info['far_over_tiles']}; group_shared_masked_kernel<poly> on its "
                          f"lists vs plain, first {HEAD_TILES} tiles: max |diff| / sum|term| = "
                          f"{poly_err:.3e} (limit 1e-5)")
                    check(rel <= 1e-5, f"octree {dim}-D farcompact forces differ")
                    check(poly_err <= 1e-5, f"{dim}-D group_shared_masked_kernel<poly> differs "
                          "from its plain version")
                    del poly, t_args
                elif dim == 3:  # desc1, desc2: the 3-D force against the exact sum
                    if ref is None:
                        ref = cfg.G * ca.allpairs_block_cuda(bodies[1], bodies[0], bodies[1], eps,
                                                             "sqrt3")
                    accuracy("9b", f"octree {token} vs sqrt3 all-pairs", big, a, ref)
                del a, rec, args
            del a0, ref, bodies
            torch.cuda.empty_cache()

    # -- (b) 17,000 bodies, 3-D, per token: the card against the CPU twins
    m, x = clusters(17000, 3)
    for tree, tokens in (("octree", OCTREE_TOKENS), ("bvh", BVH_TOKENS)):
        for token in tokens:
            runs = []
            for device in (dev, torch.device("cpu")):
                mt, xt = torch.tensor(m, device=device), torch.tensor(x, device=device)
                depth = 0
                if tree == "octree":
                    depth = octree.max_depth(17000, 3)
                    bodies = octree.morton_sort(mt, xt, *octree.robust_quant_box(xt), depth)[:3]
                else:
                    st = bvh.hilbert_sort(SystemState(mt, xt, torch.zeros_like(xt),
                                                      torch.zeros_like(xt), torch.zeros_like(xt)),
                                          eps)
                    bodies = (st.m, st.x)
                a, info, _ = ablate_eval(tree, device, bodies, depth, token, (0.5, 1.0, eps),
                                         window_tiles=2)
                runs.append((a.cpu(), info))
            check(runs[1][1]["entries"] > 0, f"9b {tree} {token}: no entries at 17,000 bodies")
            card_vs_cpu("9b", f"17000-body 3-D clusters, {tree} ablate={token}, window_tiles 2",
                        runs)

    # -- (c) python -m nbody_torch.probe knobs at 2^20 as subprocesses, one
    #    SPEC per token (and the default path) in 3-D and 2-D; each resets
    #    the launch counts before its SPEC's steps and reports them after
    specs = {"oct": [f"512,{s},32,{tok},{dim},0" for tok in ("none", *OCTREE_TOKENS)
                     for dim, s in ((3, 8192), (2, 2048))],
             "bvh": [f"512,512,32,{tok},0,{dim}" for tok in ("none", *BVH_TOKENS)
                     for dim in (3, 2)]}
    probe_rows = {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        for tree, tree_specs in specs.items():
            out = os.path.join(tmp, f"{tree}.jsonl")
            cmd = [sys.executable, "-m", "nbody_torch.probe", "knobs", tree, out, *tree_specs,
                   "--n", str(big), "--device", dev.type]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
            rows = [json.loads(line) for line in Path(out).read_text().splitlines()] \
                if os.path.exists(out) else []
            print(f"[9c] {' '.join(cmd[1:4])} OUT <{len(tree_specs)} SPECs> --n {big}: rc "
                  f"{proc.returncode}, {len(rows)} lines in {time.perf_counter() - t0:.0f} s")
            check(proc.returncode == 0 and len(rows) == len(tree_specs),
                  f"probe knobs {tree} failed: {proc.stderr[-2000:]}")
            for r in rows:
                print(f"[9c]   {json.dumps(r)}")
                probe_rows[(tree, r["spec"])] = r
    launches = {name: {} for name in ABLATE_KERNELS}
    for (tree, spec), r in probe_rows.items():
        token = spec.split(",")[3]
        tokens = OCTREE_TOKENS if tree == "oct" else BVH_TOKENS
        if token in tokens:
            name = tokens[token]
            n_launch = r["launches"].get(name, 0)
            check(n_launch > 0, f"probe {tree} {spec} launched no {name}")
            launches[name][f"{tree} {spec}"] = n_launch
    print(f"[9] phase 9 wall time {time.perf_counter() - t9:.0f} s")

    main_spec = {"masked_eval_kernel": "oct 512,8192,32,densemask,3,0",
                 "group_shared_masked_kernel": "oct 512,8192,32,farcompact,3,0",
                 "entries_lohi_kernel<packed>": "oct 512,8192,32,packedj,3,0"}
    main_call = {"masked_eval_kernel": "octree_densemask_3d",
                 "group_shared_masked_kernel": "octree_farcompact_3d",
                 "entries_lohi_kernel<packed>": "octree_packedj_3d"}
    entries = []
    for name, (_, _, _, replaces) in ABLATE_KERNELS.items():
        label = "entries_lohi_kernel<sqrt3, packed>" if "packed" in name else f"{name}<sqrt3>"
        entries.append({"name": label, "route": "cuda", "source": GROUP_EVAL,
                        "replaces": replaces, "launches": launches[name][main_spec[name]],
                        "launches_in": f"phase 9c: python -m nbody_torch.probe knobs "
                                       f"{main_spec[name]} --n {big} (1 untimed + 3 timed steps)",
                        **measured[name][main_call[name]], "n": big, "dim": 3,
                        "dtype": "float32", "launches_by_spec": launches[name],
                        "other_calls": {k: v for k, v in measured[name].items()
                                        if k != main_call[name]}})
    return entries


# -- phases 15-17: the ports of the last nbody_tpu scripts --------------------

ACC_LEGS = ("fp32fast", "f64group")
FORCE_STATS = ("vs_apf64", "relerr_p50", "relerr_p99", "relerr_max")
# the kernels each run must launch (launch_counts names), by tree
FAST_KERNELS = {"octree": ("masked_eval_bits_kernel", "window_eval_interval_kernel",
                           "entries_lohi_kernel"),
                "bvh": ("masked_eval_bits_kernel", "window_eval_nodemask_kernel",
                        "entries_lohi_kernel")}
LIST_KERNEL = {"octree": "group_eval_kernel<float64, sqrt3>",
               "bvh": "group_eval_kernel<float64, poly>"}


def counted_run(argv: list[str]):
    """python -m nbody_torch.probe argv in this process, the kernels' counts
    set to 0 just before it and read just after: (its stdout, the counts
    that are not 0)."""
    from nbody_torch import probe
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg

    ca.reset_launch_counts()
    cg.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = probe.main(argv)
    check(rc == 0, f"probe {' '.join(argv)} returned {rc}")
    launches = {k: v for k, v in {**ca.launch_counts, **cg.launch_counts}.items() if v}
    return out.getvalue(), launches


def add_script_launches(counts: dict, tag: str, algorithm: str | None, launches: dict) -> None:
    """Add a run's launches to counts[kernels line name][tag]."""
    for kernel, count in launches.items():
        name = mesh_entry_name(algorithm, kernel) if algorithm else kernel
        counts.setdefault(name, {})
        counts[name][tag] = counts[name].get(tag, 0) + count


def expect_launched(tag: str, launches: dict, names) -> None:
    missing = [k for k in names if not launches.get(k)]
    check(not missing, f"{tag}: {missing} not launched (launches {launches})")


def script_phases(dev) -> dict:
    """Phases 15-17, the ports of accuracy_study.py, probe_acc_growth.py,
    nasa.py and probe_mesh_scaling.py through python -m nbody_torch.probe,
    every output under a temporary directory. Returns the launches of each
    run by the kernels line's names and the run's tag."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.probes.nasa import read_points

    by_name = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_") as tmp:
        # -- 15a: the force error at 2^20, 3-D, fresh, both legs and trees --
        t15 = time.perf_counter()
        n15 = 1 << 20
        for algo in ("octree", "bvh"):
            out = os.path.join(tmp, f"force_{algo}.json")
            t0 = time.perf_counter()
            text, launches = counted_run(["accuracy", str(n15), "0", "--force-error", "--dims",
                                          "3", "--algos", algo, "--out", out])
            (row,) = json.load(open(out))
            keys = {"dim", "algo", "n", "steps", "theta", "evolved",
                    *(f"force_{leg}_{k}" for leg in ACC_LEGS for k in FORCE_STATS)}
            check(set(row) == keys, f"15a {algo}: keys {sorted(row)}")
            check("| dim | algo | evolved |" in text, f"15a {algo}: no table printed")
            for leg in ACC_LEGS:
                stats = [row[f"force_{leg}_{k}"] for k in FORCE_STATS]
                print(f"[15a] {n15}-body 3-D {algo} {leg} against the f64 all-pairs kernel: "
                      f"L1 {stats[0]:.4e}, per-body relative error p50 {stats[1]:.4e}, p99 "
                      f"{stats[2]:.4e}, max {stats[3]:.4e} (limits: p50 1e-3, p99 1e-2)")
                check(all(np.isfinite(stats)), f"15a {algo} {leg}: not finite")
                check(stats[1] <= 1e-3 and stats[2] <= 1e-2,
                      f"15a {algo} {leg}: far from the direct sum")
            expect_launched(f"15a {algo}", launches,
                            (*FAST_KERNELS[algo], LIST_KERNEL[algo], ca.NEWTON64))
            add_script_launches(by_name, "15a", algo, launches)
            print(f"[15a] {algo}: {time.perf_counter() - t0:.1f} s; launches {launches}")
        print(f"[15a] phase 15a wall time {time.perf_counter() - t15:.0f} s")

        # -- 15b: the growth probe at 2^17, 3-D, 5 steps -------------------
        t0 = time.perf_counter()
        out = os.path.join(tmp, "growth.jsonl")
        for algo in ("bvh", "octree"):
            _, launches = counted_run(["acc-growth", "131072", "5", "--dim", "3", "--algos", algo,
                                       "--out", out])
            expect_launched(f"15b {algo}", launches, (*FAST_KERNELS[algo], LIST_KERNEL[algo]))
            add_script_launches(by_name, "15b", algo, launches)
        rows = [json.loads(line) for line in open(out)]
        check([(r["algo"], r["step"]) for r in rows]
              == [(a, k) for a in ("bvh", "octree") for k in range(1, 6)], "15b: rows")
        for r in rows:
            check(set(r) == {"algo", "dim", "n", "step", "pos_l1", "acc_l1"}, f"15b: keys {r}")
            check(np.isfinite(r["pos_l1"]) and np.isfinite(r["acc_l1"]), f"15b: {r}")
            print(f"[15b] {r['algo']} 131072-body 3-D step {r['step']}: pos_l1 "
                  f"{r['pos_l1']:.4e}, acc_l1 {r['acc_l1']:.4e}")
            if r["step"] == 1:
                check(r["acc_l1"] <= 1e-2, f"15b {r['algo']}: step 1's acc_l1 above 1e-2")
        print(f"[15b] phase 15b wall time {time.perf_counter() - t0:.0f} s (limit on step 1's "
              f"acc_l1: 1e-2)")

        # -- 15c: trajectories from an evolved start against the f64 all-pairs
        #    oracle, a run per tree (the octree's makes the pre-roll, on its
        #    fast path, which the BVH's then reads)
        t0 = time.perf_counter()
        skipped = []
        for algo in ("octree", "bvh"):
            out = os.path.join(tmp, f"evolved_{algo}.json")
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                _, launches = counted_run(["accuracy", "65536", "5", "--dims", "2", "--evolved",
                                           "--algos", algo, "--out", out])
            sys.stderr.write(err.getvalue())
            skipped += [line for line in err.getvalue().splitlines()
                        if line.startswith("# reference legs skipped: ")]
            (r,) = json.load(open(out))
            cols = {k: v for k, v in r.items() if k.startswith("ours_")}
            check(r["algo"] == algo and r["evolved"] is True
                  and set(cols) == {"ours_fp32fast_vs_f64group",
                                    "ours_fp32fast_vs_f64group_canon",
                                    "ours_fp32fast_vs_oracle", "ours_f64group_vs_oracle"},
                  f"15c: row {r}")
            check(all(np.isfinite(v) for v in cols.values()), f"15c: {r}")
            print(f"[15c] 65536-body 2-D {algo}, 5 steps from the 50-step pre-roll: "
                  + ", ".join(f"{k} {v:.4e}" for k, v in cols.items()))
            expect_launched(f"15c {algo}", launches,
                            (*FAST_KERNELS[algo], LIST_KERNEL[algo], ca.NEWTON64))
            add_script_launches(by_name, "15c", algo, launches)
        check(len(skipped) == 2, "15c: no reason printed for the reference legs")
        print(f"[15c] {skipped[0]}; phase 15c wall time {time.perf_counter() - t0:.0f} s")

        # -- 16: the NASA pipeline on the card and on the CPU ---------------
        t0 = time.perf_counter()
        finals = {}
        for device in ("cuda", "cpu"):
            work = os.path.join(tmp, f"nasa_{device}")
            text, launches = counted_run(["nasa", "--synthetic", "2000", "--steps", "25",
                                          "--workdir", work, "--device", device])
            lines = text.splitlines()
            check("# octree vs all-pairs final positions:" in lines, f"16 {device}: {lines}")
            i = lines.index("# octree vs all-pairs final positions:")
            check(lines[i + 1].startswith("Total absolute difference is ")
                  and lines[i + 2].startswith("Absolute difference per body is "),
                  f"16 {device}: {lines[i:i + 3]}")
            print(f"[16] --device {device}: {lines[i + 1]}; {lines[i + 2]}")
            finals[device] = {algo: read_points(os.path.join(work, algo, "positions.bin"))[-1].T
                              for algo in ("octree", "all_pairs")}
            if device == "cuda":
                expect_launched("16", launches, (LIST_KERNEL["octree"], ca.NEWTON64))
                add_script_launches(by_name, "16", None, launches)
                print(f"[16] launches on the card: {launches}")
            else:
                check(not launches, f"16 --device cpu launched {launches}")
        for algo in ("octree", "all_pairs"):
            gpu, cpu = finals["cuda"][algo], finals["cpu"][algo]
            check(gpu.shape == (2000, 3) and bool(np.isfinite(gpu).all()), f"16 {algo}: shape")
            diff = float((np.abs(gpu - cpu).max(axis=0) / np.abs(cpu).max(axis=0)).max())
            print(f"[16] {algo} final positions, card vs --device cpu: max over columns of max "
                  f"|diff| / max |value| = {diff:.3e} (limit 1e-6)")
            check(diff <= 1e-6, f"16 {algo}: card and CPU final positions differ")
        print(f"[16] phase 16 wall time {time.perf_counter() - t0:.0f} s")

        # -- 17: the mesh-scaling table, the ranks sharing the card ---------
        t0 = time.perf_counter()
        table = os.path.join(tmp, "scaling.md")
        text, _ = counted_run(["mesh-scaling", "--n", "32768", "--steps", "3", "--out", table])
        rows = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
        check([r["S"] for r in rows] == [1, 2, 4, 8], f"17: rows {rows}")
        layout_algo = {"ring_allpairs": "all-pairs", "sharded_bvh": "bvh"}
        for r in rows:
            keys = ["S", "n", "ring_allpairs_s", "sharded_bvh_s", "sharded_octree_s",
                    "partitioned_octree_s", *(["partitioned_2d_s"] if r["S"] >= 4 else []),
                    "partitioned_weak_n", "partitioned_weak_s"]
            check(list(r)[:len(keys)] == keys, f"17: keys {list(r)}")
            check(all(r[k] > 0 for k in keys if k.endswith("_s")), f"17: times {r}")
            print(f"[17] S={r['S']} backend {r['backend']}, {r['ranks_per_card']} ranks a card: "
                  + ", ".join(f"{k} {r[k]:.4f}" for k in keys[2:] if k.endswith("_s"))
                  + f" (weak n {r['partitioned_weak_n']})")
            for layout, counts in r["launches"].items():
                algo = layout_algo.get(layout, "octree")
                want = (ca.NEWTON,) if algo == "all-pairs" else (
                    FAST_KERNELS[algo] if layout.startswith("sharded")
                    else ("masked_eval_bits_kernel", "window_eval_interval_kernel"))
                expect_launched(f"17 S={r['S']} {layout}", counts, want)
                add_script_launches(by_name, "17", algo, counts)
        text = open(table).read()
        print(text, end="")
        check(text.startswith("| S | ring all-pairs | sharded bvh | sharded octree | "
                              "partitioned octree | partitioned 2-D (S/2 x 2) | "
                              "partitioned weak (n=n*S/8) |")
              and len(text.splitlines()) == 6, "17: table")
        print(f"[17] on {torch.cuda.device_count()} card(s): ranks that share a card give no "
              f"scaling figure; phase 17 wall time {time.perf_counter() - t0:.0f} s")
    return by_name


SCRIPT_RUNS = {"15a": "phase 15a: probe accuracy 1048576 0 --force-error --dims 3, per tree",
               "15b": "phase 15b: probe acc-growth 131072 5 --dim 3, per tree",
               "15c": "phase 15c: probe accuracy 65536 5 --dims 2 --evolved, per tree",
               "16": "phase 16: probe nasa --synthetic 2000 --steps 25 on the card",
               "17": "phase 17: probe mesh-scaling --n 32768 --steps 3, summed over ranks and S"}



# -- phase 14: the A/B modes of the ablate tokens ------------------------------

# mode name -> (wrapper in ops.cuda_group_eval, its twin, the keyword arguments
# of the instantiation beside the mode's own (packed), the TPU kernel and
# the argument that selects the mode there)
MODE_KERNELS = {
    "masked_eval_bits_kernel<tg2>": ("masked_eval_bits_cuda", "masked_eval_bits_torch", {},
                                     f"{PALLAS_GROUP_EVAL}:310 (tile_group=2, body :290-301)"),
    "window_eval_interval_kernel<full>": ("window_eval_interval_cuda",
                                          "window_eval_interval_torch", {},
                                          f"{PALLAS_GROUP_EVAL}:502 (skip_outside=False)"),
    "window_eval_nodemask_kernel<full>": ("window_eval_nodemask_cuda",
                                          "window_eval_nodemask_torch", {},
                                          f"{PALLAS_GROUP_EVAL}:614 (skip_outside=False)"),
    "entries_lohi_kernel<span>": ("entries_lohi_eval_cuda", "entries_lohi_eval_torch", {},
                                  f"{PALLAS_GROUP_EVAL}:963 (sub_width / skip_empty=False)"),
    "entries_lohi_kernel<packed, span>": ("entries_lohi_eval_cuda", "entries_lohi_eval_torch",
                                          {"packed": True},
                                          f"{PALLAS_GROUP_EVAL}:1040 (packed_j with sub_width / "
                                          "skip_empty=False)"),
}
MODE_HEAD = 32  # 14a: the twins on the first 32 tiles of each 2^20 call
# 14b: one 3-D SPEC a token of each tree at 2^20; the mode kernel a token brings
OCTREE_KNOBS = {"epg1": None, "epg8": None, "epg16": None,
                "subw1024": "entries_lohi_kernel<span>", "fheapcap1024": None, "nofheap": None,
                "wj1": None, "wj2": None, "sidefloor": None, "mono": None, "subdiag": None,
                "pbdiag": None, "ftg2": "masked_eval_bits_kernel<tg2>",
                "nowinskip": "window_eval_interval_kernel<full>", "wordextract": None,
                "widextract": None, "noskip": "entries_lohi_kernel<span>", "far": None,
                "win": None, "near": None, "nlist": None, "desc2.dbg": None,
                "packedj.subw1024": "entries_lohi_kernel<packed, span>", "winskip": None}
BVH_KNOBS = {"epg1": None, "epg8": None, "epg16": None, "subw512": "entries_lohi_kernel<span>",
             "dblk2048": None, "dblk0": None, "wj1": None, "wj2": None, "win": None, "far": None,
             "resid": None, "rlist": None, "ftg2": "masked_eval_bits_kernel<tg2>",
             "nowinskip": "window_eval_nodemask_kernel<full>", "winskip": None}
# the keys a token's line must carry beyond the scripts' (KNOB_KEYS)
KNOB_TOKEN_KEYS = {"subdiag": ("near_width_cell_tile", "near_width_cell_subtile_xnsub"),
                   "pbdiag": ("pb_width_box", "pb_width_com", "pb_width_tile"),
                   "desc2.dbg": ("descend_open_2",)}


def mode_head(wrapper: str, args, tiles: int):
    """A mode call's args cut to its first `tiles` row tiles, and their rows."""
    xi = args[0]
    if wrapper == "entries_lohi_eval_cuda":
        return head_args("entries_lohi_kernel", args, tiles)
    ntiles = args[3].shape[0]
    tb = xi.shape[0] // ntiles
    cut = [a[:tiles] if i >= 3 and hasattr(a, "shape") and a.shape[:1] == (ntiles,) else a
           for i, a in enumerate(args)]
    return (xi[:tiles * tb], *cut[1:]), tiles * tb


def mode_pairs(name: str, args, kw) -> int:
    """The (row, source) pairs a mode's kernel visits, masked ones included:
    tg2, each pair of tiles' rows against the union of their accepted
    nodes; the full windows, every window column below nj; the span mode,
    each entry's visited span (entry_spans)."""
    import torch

    from nbody_torch.ops import cuda_group_eval as cg

    xi, mj = args[0], args[1]
    nj = mj.shape[0]
    if name == "masked_eval_bits_kernel<tg2>":
        words = args[3]
        tb = xi.shape[0] // words.shape[0]
        pairs = torch.nn.functional.pad(words, (0, 0, 0, words.shape[0] % 2)).view(-1, 2,
                                                                                   words.shape[1])
        union = cg.unpack_mask_bits(pairs[:, 0] | pairs[:, 1], nj).sum(1)
        rows = torch.full_like(union, 2 * tb)
        rows[-1] -= tb * (words.shape[0] % 2)
        return int((union * rows).sum())
    if name.startswith("entries_lohi_kernel"):
        ent, lohi, n_real, S = args[3], args[4], int(args[5]), args[6]
        _, start, stop, _, _ = cg.entry_spans(ent[:n_real], lohi[:n_real], S,
                                              kw.get("sub_width"), kw.get("skip_empty", True))
        tb = xi.shape[0] // args[7]
        return int((stop.clamp_max(nj) - start.clamp_max(nj)).clamp_min(0).sum()) * tb
    w0 = args[3].long()
    tb = xi.shape[0] // w0.shape[0]
    # window_tiles: args[7] of the interval window, args[6] of the node-mask one
    wt = args[6] if name.startswith("window_eval_nodemask") else args[7]
    cols = torch.clamp(nj - w0 * tb, min=0).clamp_max(wt * tb)
    return int(cols.sum()) * tb


def mode_check(tag: str, name: str, args, kwargs, mode_kw: dict, dim: int,
               softening: str) -> dict:
    """14a: a mode's call on a default path's recorded 2^20 args against
    the default mode's call (within 1e-6 of sum |a|; bit-equal printed)
    and against its twin on the first MODE_HEAD tiles (1e-5 of sum
    |term|); both timed on the device alone (device_ms); the bound on the
    pairs the mode visits."""
    import torch

    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.probes.compare_trees import device_ms

    wrapper, twin_name, kind_kw, _ = MODE_KERNELS[name]
    kern, twin = getattr(cg, wrapper), getattr(cg, twin_name)
    base_kw = {**kwargs, **kind_kw}
    kw = {**base_kw, **mode_kw}
    cg.reset_launch_counts()
    default, got = kern(*args, **base_kw), kern(*args, **kw)
    torch.cuda.synchronize()
    check(cg.launch_counts[name] == 1, f"{tag}: {name} not launched ({cg.launch_counts})")
    same = torch.equal(got, default)
    rel = ((got - default).abs().sum() / default.abs().sum()).item()
    # the entries calls' plan enqueues ~50 torch ops a call (~1.7 ms):
    # they queue behind a longer sleep
    sleep_us = 5000.0 if wrapper == "entries_lohi_eval_cuda" else 500.0
    ms, ms_default = (device_ms(lambda: kern(*args, **k), reps=3, sleep_us=sleep_us)
                      for k in (kw, base_kw))
    ntiles = args[7] if wrapper == "entries_lohi_eval_cuda" else args[3].shape[0]
    h_args, rows = mode_head(wrapper, args, min(MODE_HEAD, ntiles))
    twin_kw = {k: v for k, v in kw.items() if k != "parts"}
    plain_ms, ref = event_ms(lambda: twin(*h_args, **twin_kw), reps=1, keep=True)
    err, abs_err = scaled(got[:rows], ref, twin(*h_args, absolute=True, **twin_kw))
    pairs, flops = mode_pairs(name, args, kw), flops_per_pair(dim, softening)
    bound_ms, bound_by = bound(pairs, flops, bytes_of(args))
    print(f"[{tag}] {name}<{softening}> {mode_kw}: device {ms:.4f} ms, default mode "
          f"{ms_default:.4f} ms; vs the default mode {'bit-equal' if same else 'not bit-equal'}, "
          f"sum|diff| / sum|a| = {rel:.3e} (limit 1e-6); vs plain on {rows} rows ({plain_ms:.1f} "
          f"ms): max |diff| / sum|term| = {err:.3e} (limit 1e-5); {pairs} pairs visited, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    check(rel <= 1e-6, f"{tag}: {name} differs from the default mode")
    check(err <= 1e-5, f"{tag}: {name} differs from its twin")
    return {"ms": ms, "default_mode_ms": ms_default, "plain_ms": plain_ms, "plain_rows": rows,
            "max_abs_err": abs_err, "max_scaled_err": err, "vs_default_rel": rel,
            "vs_default_bit_equal": same, "pairs": pairs, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "mode": {k: v for k, v in mode_kw.items()}}


def mode_phases(dev, big: int) -> list:
    """Phase 14: the four kernel modes of the ablate tokens (14a, on a
    default path's recorded 2^20 calls) and the knob probe with one SPEC a
    token of each tree at 2^20 (14b). Returns the modes' JSON entries."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh, bvh_group, octree, octree_group
    from nbody_torch.probe import KNOB_KEYS

    t14 = time.perf_counter()
    measured = {name: {} for name in MODE_KERNELS}
    wrappers = ["masked_eval_bits_cuda", "window_eval_interval_cuda",
                "window_eval_nodemask_cuda", "entries_lohi_eval_cuda"]
    # (tree, dim) -> [(mode, the recorded wrapper, the mode's keyword arguments)]
    plan = {("octree", 3): [("masked_eval_bits_kernel<tg2>", "masked_eval_bits_cuda",
                             {"tile_group": 2}),
                            ("window_eval_interval_kernel<full>", "window_eval_interval_cuda",
                             {"skip_outside": False}),
                            ("entries_lohi_kernel<span>", "entries_lohi_eval_cuda",
                             {"sub_width": 1024}),
                            ("entries_lohi_kernel<span>", "entries_lohi_eval_cuda",
                             {"skip_empty": False}),
                            ("entries_lohi_kernel<packed, span>", "entries_lohi_eval_cuda",
                             {"sub_width": 1024})],
            ("octree", 2): [("window_eval_interval_kernel<full>", "window_eval_interval_cuda",
                             {"skip_outside": False}),
                            ("entries_lohi_kernel<span>", "entries_lohi_eval_cuda",
                             {"sub_width": 256})],
            ("bvh", 3): [("masked_eval_bits_kernel<tg2>", "masked_eval_bits_cuda",
                          {"tile_group": 2}),
                         ("window_eval_nodemask_kernel<full>", "window_eval_nodemask_cuda",
                          {"skip_outside": False}),
                         ("entries_lohi_kernel<span>", "entries_lohi_eval_cuda",
                          {"sub_width": 512})]}
    for (tree, dim), modes in plan.items():
        softening = "sqrt3" if tree == "octree" else "poly"
        cfg, state = build_model("galaxy", big, dim, np.float32, device=dev)
        eps = cfg.eps
        module = octree_group if tree == "octree" else bvh_group
        with recording(module, [w for w in wrappers if hasattr(module, w)]) as rec:
            if tree == "octree":
                depth = octree.max_depth(big, dim)
                lo, hi = octree.robust_quant_box(state.x)
                ms, xs, ks = octree.morton_sort(state.m, state.x, lo, hi, depth)[:3]
                octree_group.compute_force_grouped_fast(ms, xs, ks, depth, cfg.theta, cfg.G, eps)
            else:
                st = bvh.hilbert_sort(state, eps)
                bvh_group.compute_force_grouped_windowed(bvh.build_tree(st.m, st.x, eps), st.m,
                                                         st.x, cfg.theta, cfg.G, eps)
            torch.cuda.synchronize()
        del state
        for name, wrapper, mode_kw in modes:
            key = f"{tree}_{dim}d_" + "_".join(f"{k}{v}" for k, v in mode_kw.items())
            measured[name][key] = mode_check(f"14a {dim}-D {tree}", name, rec[wrapper],
                                             rec.kwargs[wrapper], mode_kw, dim, softening)
        del rec
        torch.cuda.empty_cache()

    # -- (b) python -m nbody_torch.probe knobs at 2^20, one fresh 3-D SPEC
    #    a token of each tree; each SPEC's launches counted from 0
    specs = {"oct": {f"512,8192,32,{tok},3,0": tok for tok in OCTREE_KNOBS},
             "bvh": {f"512,512,32,{tok},0,3": tok for tok in BVH_KNOBS}}
    launches = {name: {} for name in MODE_KERNELS}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        for tree, tree_specs in specs.items():
            out = os.path.join(tmp, f"{tree}.jsonl")
            cmd = [sys.executable, "-m", "nbody_torch.probe", "knobs", tree, out, *tree_specs,
                   "--n", str(big), "--device", dev.type]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=root)
            rows = [json.loads(line) for line in Path(out).read_text().splitlines()] \
                if os.path.exists(out) else []
            print(f"[14b] {' '.join(cmd[1:4])} OUT <{len(tree_specs)} SPECs> --n {big}: rc "
                  f"{proc.returncode}, {len(rows)} lines in {time.perf_counter() - t0:.0f} s")
            check(proc.returncode == 0 and len(rows) == len(tree_specs),
                  f"probe knobs {tree} failed: {proc.stderr[-2000:]}")
            table = OCTREE_KNOBS if tree == "oct" else BVH_KNOBS
            for r in rows:
                tok = tree_specs[r["spec"]]
                print(f"[14b]   {json.dumps(r)}")
                want = set(KNOB_KEYS[tree]) - {"far_heap_nonempty", "near_width_cell_tile",
                                               "near_width_cell_subtile_xnsub"}
                want |= set(KNOB_TOKEN_KEYS.get(tok, ()))
                check(want <= set(r), f"probe {tree} {r['spec']} lacks {want - set(r)}")
                check(np.isfinite(r["sec"]) and r["sec"] > 0, f"probe {tree} {r['spec']}: sec")
                if table[tok]:
                    n_launch = r["launches"].get(table[tok], 0)
                    check(n_launch > 0, f"probe {tree} {r['spec']} launched no {table[tok]}")
                    launches[table[tok]][f"{tree} {r['spec']}"] = n_launch
    print(f"[14] phase 14 wall time {time.perf_counter() - t14:.0f} s")

    main_spec = {"masked_eval_bits_kernel<tg2>": ("oct 512,8192,32,ftg2,3,0", "octree_3d_tile_group2"),
                 "window_eval_interval_kernel<full>": ("oct 512,8192,32,nowinskip,3,0",
                                                       "octree_3d_skip_outsideFalse"),
                 "window_eval_nodemask_kernel<full>": ("bvh 512,512,32,nowinskip,0,3",
                                                       "bvh_3d_skip_outsideFalse"),
                 "entries_lohi_kernel<span>": ("oct 512,8192,32,subw1024,3,0",
                                               "octree_3d_sub_width1024"),
                 "entries_lohi_kernel<packed, span>": ("oct 512,8192,32,packedj.subw1024,3,0",
                                                       "octree_3d_sub_width1024")}
    entries = []
    for name, (_, _, _, replaces) in MODE_KERNELS.items():
        spec, call = main_spec[name]
        soft = "poly" if spec.startswith("bvh") else "sqrt3"
        base, _, mode = name.partition("<")
        entries.append({"name": f"{base}<{soft}, {mode}", "route": "cuda", "source": GROUP_EVAL,
                        "replaces": replaces, "launches": launches[name][spec],
                        "launches_in": f"phase 14b: python -m nbody_torch.probe knobs {spec} "
                                       f"--n {big} (1 untimed + 3 timed steps)",
                        **measured[name][call], "n": big, "dim": 3, "dtype": "float32",
                        "launches_by_spec": launches[name],
                        "other_calls": {k: v for k, v in measured[name].items() if k != call}})
    return entries


ENTRY_PROBES = "nbody_torch/csrc/entry_probes.cu"
OVERHEAD_SCRIPT = "scripts/probe_entry_overhead.py"
DMA_SCRIPT = "scripts/probe_dma_pipeline.py"
RUNG_REPLACES = {"ideal": f"{OVERHEAD_SCRIPT}:188", "sepmj": f"{OVERHEAD_SCRIPT}:197",
                 "sel": f"{OVERHEAD_SCRIPT}:210", "when": f"{OVERHEAD_SCRIPT}:210",
                 "switch": f"{OVERHEAD_SCRIPT}:225", "noskip": f"{PALLAS_GROUP_EVAL}:963"}
# the entry-overhead mode whose line carries each rung's launches
RUNG_MODE = {"ideal": "ideal", "sepmj": "sepmj", "sel": "sel", "when": "when",
             "switch": "switch", "noskip": "prod_noskip"}
PROBE_ROWS = 8192  # 10a: the plain version of the 2^20 entries calls on the first 8,192 rows


def run_probe(tag: str, argv: list[str], records):
    """python -m nbody_torch.probe <argv> --device cuda in this process,
    with the wrappers records = [(module, attrs, key)] recorded; returns
    (its JSON lines, {module name: the recorded calls})."""
    from nbody_torch import probe

    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        out = os.path.join(tmp, "probe.jsonl")
        recs = {mod.__name__: stack.enter_context(recording(mod, attrs, key))
                for mod, attrs, key in records}
        t0 = time.perf_counter()
        rc = probe.main([argv[0], out, *argv[1:], "--device", "cuda"])
        wall = time.perf_counter() - t0
        rows = [json.loads(line) for line in Path(out).read_text().splitlines()]
    print(f"[{tag}] python -m nbody_torch.probe {argv[0]} OUT {' '.join(argv[1:])} --device cuda: "
          f"rc {rc}, {len(rows)} lines in {wall:.1f} s")
    for r in rows:
        print(f"[{tag}]   {json.dumps(r)}")
    check(rc == 0, f"probe {argv[0]} failed")
    return rows, recs


def double(a):
    """a with its floating tensors (and those of a tuple) in float64."""
    import torch

    if isinstance(a, tuple):
        return tuple(double(v) for v in a)
    return a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a


def measure_kernel(tag: str, name: str, run, plain, pairs: int, flops: int, nbytes: int,
                   rows: int | None = None, plain_all=None) -> dict:
    """Time run() (5 launches after a warm-up, CUDA events) and its plain
    version plain(conv, absolute) on the first `rows` rows of run()'s
    output (all when None; one call after an untimed one; conv maps the
    plain version's inputs, `double` to float64); hold the kernel against
    it, and both against the plain version in float64, within 1e-5 of each
    row's sum of |term|; the bound from the pairs (or reads) and bytes its
    inputs need. plain_all(), where given, is the plain version on every
    row: its time replaces the first rows' where they extrapolate to
    under 20 s."""
    got = run()  # warm-up launch
    kms = event_ms(run, reps=5)
    total = got.shape[0]
    rows = total if rows is None else rows
    plain(lambda a: a, False)  # its first call (the first of a phase loads torch's kernels)
    plain_ms, ref = event_ms(lambda: plain(lambda a: a, False), reps=1, keep=True)
    scale = plain(lambda a: a, True)
    err, abs_err = scaled(got[:rows], ref, scale)
    ref64 = plain(double, False)
    err64 = [scaled(v, ref64, scale)[0] for v in (got[:rows], ref)]
    del got, ref, ref64, scale
    plain_rows = rows
    if plain_all is not None and rows < total and plain_ms * total / rows <= 20e3:
        plain_ms, plain_rows = event_ms(plain_all, reps=1), total
    bound_ms, bound_by = bound(pairs, flops, nbytes)
    print(f"[{tag}] {name}: kernel {kms:.3f} ms, plain {plain_ms:.1f} ms on {plain_rows} of "
          f"{total} rows; on the first {rows} rows max |kernel - plain| / sum|term| = {err:.3e} "
          f"(limit 1e-5), against float64: kernel {err64[0]:.3e}, plain {err64[1]:.3e}; {pairs} "
          f"pairs ({pairs / (kms * 1e-3):.4e} /s), {flops} operations each, {nbytes} bytes; "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    check(err <= 1e-5, f"{tag} {name}: scaled error {err:.3e} above 1e-5")
    check(err64[0] <= 1e-5, f"{tag} {name}: scaled error against float64 {err64[0]:.3e} above 1e-5")
    return {"ms": kms, "plain_ms": plain_ms, "plain_rows": plain_rows, "checked_rows": rows,
            "max_abs_err": abs_err, "max_scaled_err": err, "max_scaled_err_vs_float64": err64[0],
            "pairs": pairs, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def tensor_bytes(*tensors) -> int:
    """Each distinct tensor read (or written) once."""
    seen = {t.data_ptr(): t.numel() * t.element_size() for t in tensors}
    return sum(seen.values())


def probe_phases(dev, big: int, probe_sass):
    """Phase 10: the entry-cost probes (python -m nbody_torch.probe entries,
    entry-overhead, dma-pipeline) and their kernels (probe_sass:
    start_sass's future for entry_probes.cu). Returns the JSON entries of
    entries_tables_kernel, the ladder's rungs and the copy ring."""
    import torch

    from nbody_torch.ops import cuda_entry_probes as ce
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.probes.compare_trees import device_ms

    t10 = time.perf_counter()
    entries = []

    # -- (a) probe entries at 2^20, every mode; each recorded call of the
    #    table-driven kernel re-run, timed, and held against the plain
    #    version on the first 8,192 rows
    rows, recs = run_probe("10a", ["entries", "--n", str(big)],
                           [(cg, ["entries_tables_eval_cuda"], lambda a, args, kw: id(args[3]))])
    timed = [r for r in rows if r["probe"] == "entries"]
    check(len(timed) == 5 and rows[-1] == {"probe": "entries_done"}, "probe entries lines")
    calls = list(recs[cg.__name__].values())
    check(len(calls) == 5, f"{len(calls)} distinct entries calls recorded, expected 5")
    measured = {}
    for r, args in zip(timed, calls):
        c, m, _, ents, blk, lohi, eps, S, tb = args
        flat = ents.reshape(-1)
        g = (flat & 0xFFFF).long()
        lh = lohi.long()[g]
        width = (torch.clamp(lh >> 16, max=S) - (lh & 0xFFFF)).clamp_min(0)
        pairs = int(width.sum()) * tb
        head = flat[(flat >> 16) < PROBE_ROWS // tb]
        nbytes = tensor_bytes(c, m, ents, blk, lohi) + c.numel() * c.element_size()
        label = f"{r['mode']} S={S}"
        for softening in ("sqrt3", "poly") if (S, r["mode"]) == (1024, "real") else ("sqrt3",):
            res = measure_kernel(
                f"10a {label}", f"entries_tables_kernel<{softening}>",
                lambda: cg.entries_tables_eval_cuda(*args, softening=softening),
                lambda conv, absolute: cg.entries_tables_eval_torch(
                    conv(c[:PROBE_ROWS]), conv(m), conv(c), head, blk, lohi, eps, S, tb,
                    softening, absolute=absolute),
                pairs, flops_per_pair(3, softening), nbytes, rows=PROBE_ROWS)
            measured[f"{label} {softening}"] = {**res, "entries": r["E"], **(
                {"launches": r["launches"].get("entries_tables_kernel", 0)} if softening == "sqrt3"
                else {"launches": 0, "off_path": "the poly instantiation on this mode's recorded "
                                                 "call; the probe launches sqrt3 only"})}
        check(r["launches"].get("entries_tables_kernel", 0) > 0,
              f"probe entries {label} launched no entries_tables_kernel")
    main = measured.pop("real S=1024 sqrt3")
    entries.append({"name": "entries_tables_kernel<sqrt3>", "route": "cuda", "source": GROUP_EVAL,
                    "replaces": f"{PALLAS_GROUP_EVAL}:1126", **main,
                    "launches_in": f"phase 10a: python -m nbody_torch.probe entries --n {big}, "
                                   "mode (1024, real) (1 untimed + 8 timed calls)",
                    "n": big, "dim": 3, "dtype": "float32", "S": 1024,
                    "launches_by_mode": {k: v["launches"] for k, v in measured.items()
                                         if k.endswith("sqrt3")},
                    "other_calls": measured})
    del calls, recs
    torch.cuda.empty_cache()

    # -- (b) probe entry-overhead at S 1,024 and 512, T 128, every mode:
    #    the equivalence lines checked; each rung's recorded S = 1,024 call
    #    re-run and held against its plain version on all its rows, beside
    #    its MUFU floor, its P and its SASS; the ideal rung over P = 1-8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ladder_calls, overhead_rows = {}, {}
    for S in (1024, 512):
        rows, recs = run_probe(f"10b S={S}", ["entry-overhead", "all", str(S), "128"],
                               [(ce, ["entry_ladder_cuda"], lambda a, args, kw: args[0]),
                                (cg, ["entries_lohi_eval_cuda"],
                                 lambda a, args, kw: "prod_packed" if kw.get("packed") else "prod")])
        equiv = {r["pair"]: r["rel_err"] for r in rows if r["probe"] == "entov_equiv"}
        overhead_rows[S] = {r["mode"]: r for r in rows if r["probe"] == "entov"}
        check(len(overhead_rows[S]) == 9 and len(equiv) == 3, f"entry-overhead S={S} lines")
        check(equiv["ideal==sepmj"] == 0 and equiv["sel==when"] == 0,
              f"entry-overhead S={S}: ideal / sepmj or sel / when differ: {equiv}")
        lad, prod = recs[ce.__name__], recs[cg.__name__]
        sw = ce.entry_ladder_cuda(*lad["switch"], **lad.kwargs["switch"])
        pr = cg.entries_lohi_eval_cuda(*prod["prod"], **prod.kwargs["prod"])
        rung, x, src, ents, lohis, S_ = lad["switch"][:6]
        scale = ce.entry_ladder_torch(rung, x, src, ents, lohis, S_, tb=512, absolute=True)
        err = scaled(sw, pr, scale)[0]
        print(f"[10b S={S}] switch vs prod (entries_lohi_kernel) on the same entries: max |diff| "
              f"/ sum|term| = {err:.3e} (limit 1e-5); the probe's rel_err {equiv['switch==prod']:.3e}")
        check(err <= 1e-5, f"entry-overhead S={S}: switch and prod differ")
        lines = overhead_rows[S]
        for m, r in lines.items():
            print(f"[10b S={S}] {m}: {r['sec_per_call'] * 1e3:.3f} ms a call, "
                  f"{r['us_per_entry']:.4f} us an entry, {r['pairs']} computed pairs "
                  f"({r['pairs_per_s']:.4e} /s), MUFU floor {r['mufu_floor_ms']:.3f} ms "
                  f"({r['mufu_share']:.3f} of the call), P {r['parts']}")
        print(f"[10b S={S}] the ladder, us an entry: " + ", ".join(
            f"{b_} - {a_} {lines[b_]['us_per_entry'] - lines[a_]['us_per_entry']:+.4f}"
            for b_, a_ in LADDER_STEPS))
        print(f"[10b S={S}] pairs/s: ideal {lines['ideal']['pairs_per_s']:.4e}, prod "
              f"{lines['prod']['pairs_per_s']:.4e} (entries_lohi_kernel, its plan and second "
              f"pass), prod_packed {lines['prod_packed']['pairs_per_s']:.4e}")
        if S == 1024:
            ladder_calls = {k: (v, lad.kwargs[k]) for k, v in lad.items()}
        del recs, lad, prod, sw, pr, scale
    sass_rows = probe_sass.result(timeout=600)[1]
    for rung in ce.RUNGS:
        args, kw = ladder_calls[rung]
        _, x, src, ents, lohis, S = args[:6]
        tid, start, stop = ce._ladder_ranges(rung, ents, lohis, S)
        pairs = int((stop - start).clamp_min(0).sum()) * 512
        srcs = src if isinstance(src, tuple) else (src,)
        nbytes = tensor_bytes(x, *srcs, ents, *((lohis,) if lohis is not None else ())) \
            + x.numel() * x.element_size()
        res = measure_kernel(
            "10b S=1024", ce.ladder_name(rung), lambda: ce.entry_ladder_cuda(*args, **kw),
            lambda conv, absolute: ce.entry_ladder_torch(rung, conv(x), conv(src), ents, lohis, S,
                                                         tb=512, absolute=absolute),
            pairs, flops_per_pair(3, "sqrt3"), nbytes)
        line = overhead_rows[1024][RUNG_MODE[rung]]
        launches = line["launches"].get(ce.ladder_name(rung), 0)
        check(launches > 0, f"entry-overhead {RUNG_MODE[rung]} launched no {ce.ladder_name(rung)}")
        computed = line["pairs"]  # every lane of each entry the rung runs
        floor = mufu_floor_ms(computed, sms)
        P = ce.default_parts(int(ents.shape[0]), kw["per_block"], sms)
        check(line["parts"] == P, f"entry-overhead {rung}: P {line['parts']}, expected {P}")
        sass = probe_kernel_sass(sass_rows, "entry_ladder_kernel",
                                 ladder_args(ce.RUNGS[rung], True, ce.LADDER_BLOCKS))
        budget = line["budget"]  # from the CUDA runtime, in the probe's run
        check(budget["blocks_an_sm"] >= ce.LADDER_BLOCKS and budget["spill_bytes"] == 0,
              f"{ce.ladder_name(rung)}: {budget}, expected {ce.LADDER_BLOCKS} blocks an SM "
              "and no spill")
        print(f"[10b S=1024] {ce.ladder_name(rung)}: P = {P} parts a block of "
              f"{kw['per_block']} ({-(-int(ents.shape[0]) // kw['per_block']) * P} parts); "
              f"MUFU floor {floor:.3f} ms over {computed} computed pairs, {floor / res['ms']:.3f} "
              f"of the call; budget (CUDA runtime) {budget}; SASS {sass}")
        check(sass["slow_path_instructions"] == 0,
              f"{ce.ladder_name(rung)} takes an IEEE slow path: {sass}")
        entries.append({"name": ce.ladder_name(rung), "route": "cuda", "source": ENTRY_PROBES,
                        "replaces": RUNG_REPLACES[rung], **res, "launches": launches,
                        "launches_in": f"phase 10b: python -m nbody_torch.probe entry-overhead "
                                       f"all 1024 128, mode {RUNG_MODE[rung]} (1 untimed + 12 "
                                       "timed calls)",
                        "E": int(ents.shape[0]), "S": S, "T": 128, "dim": 3, "dtype": "float32",
                        "parts": P, "per_block": kw["per_block"], "computed_pairs": computed,
                        "mufu_floor_ms": floor, "mufu_share": floor / res["ms"], "sass": sass,
                        "registers": budget["registers"],
                        "blocks_an_sm": budget["blocks_an_sm"],
                        "us_per_entry": {s: overhead_rows[s][RUNG_MODE[rung]]["us_per_entry"]
                                         for s in (1024, 512)},
                        "mufu_share_by_S": {s: overhead_rows[s][RUNG_MODE[rung]]["mufu_share"]
                                            for s in (1024, 512)}})
    # the ideal rung's call over P = 1, 2, 4, 8, each within 1e-5 of sum |term|
    args, kw = ladder_calls["ideal"]
    _, x, src, ents, _, S = args[:6]
    default = ce.entry_ladder_cuda(*args, **kw)
    scale = ce.entry_ladder_torch("ideal", x, src, ents, None, S, tb=512, absolute=True)
    sweep = {}
    for P in (1, 2, 4, 8):
        run = (lambda P=P: ce.entry_ladder_cuda(*args, **kw, parts=P))
        got = run()
        sweep[P] = event_ms(run, reps=5)
        err = scaled(got, default, scale)[0]
        check(err <= 1e-5, f"10b: the ideal rung at P = {P} differs from the default by {err:.3e}")
    print(f"[10b S=1024] {ce.ladder_name('ideal')} ms a call by P: {sweep} (each within 1e-5 of "
          f"sum |term| of the default P)")
    next(e for e in entries if e["name"] == ce.ladder_name("ideal"))["ms_by_parts"] = sweep
    del ladder_calls, default, scale
    prod_us = {s: {m: overhead_rows[s][m]["us_per_entry"] for m in ("prod", "prod_packed")}
               for s in (1024, 512)}
    print(f"[10b] production kernel us per entry (entries_lohi_kernel, <packed>): {prod_us}")
    torch.cuda.empty_cache()

    # -- (c) probe dma-pipeline with and without the math: the equivalence
    #    lines checked (limit 1e-6); each recorded call re-run and held
    #    against its plain version, beside its MUFU floor (math 1), SASS and
    #    budget (the CUDA runtime's registers and blocks an SM: blockspec and the
    #    rings are built at one launch bound, ce.RING_BLOCKS)
    ideal_ms = next(e["ms"] for e in entries if e["name"] == ce.ladder_name("ideal"))
    for math in (1, 0):
        ring_ms = {}
        rows, recs = run_probe(f"10c math={math}", ["dma-pipeline", "all", "--math", str(math)],
                               [(ce, ["entry_ladder_cuda", "dma_ring_cuda"],
                                 lambda a, args, kw: a if a == "entry_ladder_cuda" else args[4])])
        equiv = [r for r in rows if r["probe"] == "dmapipe_equiv"]
        timed = {r["mode"]: r for r in rows if r["probe"] == "dmapipe"}
        check(len(equiv) == 2 and len(timed) == 3, f"dma-pipeline math={math} lines")
        check(all(r["rel_err"] <= 1e-6 for r in equiv),
              f"dma-pipeline math={math}: the modes differ: {equiv}")
        rec = recs[ce.__name__]
        for mode, key in (("blockspec", "entry_ladder_cuda"), ("manual2", 2), ("manual4", 4)):
            args, kw = rec[key], rec.kwargs[key]
            if key == "entry_ladder_cuda":
                _, x, xm, ents, _, S = args[:6]
                name = ce.ladder_name("ideal", bool(math), ce.RING_BLOCKS)
                run = (lambda args=args, kw=kw: ce.entry_ladder_cuda(*args, **kw))
                sass = probe_kernel_sass(sass_rows, "entry_ladder_kernel",
                                         ladder_args(ce.RUNGS["ideal"], bool(math),
                                                     ce.RING_BLOCKS))
            else:
                x, xm, ents, S = args[:4]
                name = ce.ring_name(key, bool(math))
                run = (lambda args=args, kw=kw: ce.dma_ring_cuda(*args, **kw))
                sass = probe_kernel_sass(sass_rows, "dma_ring_kernel",
                                         f"(int)3, (int){key}, (bool){math}")
            E = int(ents.shape[0])
            nbytes = tensor_bytes(x, xm, ents) + x.numel() * x.element_size()
            pairs, flops = (E * S * 512, flops_per_pair(3, "sqrt3")) if math else (E * S, 3)
            res = measure_kernel(
                f"10c math={math}", name, run,
                lambda conv, absolute, x=x, xm=xm, ents=ents, S=S: ce.dma_ring_torch(
                    conv(x), conv(xm), ents, S, math=bool(math), absolute=absolute),
                pairs, flops, nbytes)
            launches = timed[mode]["launches"].get(name, 0)
            check(launches > 0, f"dma-pipeline {mode} math={math} launched no {name}")
            P = timed[mode]["parts"]
            check(P == ce.default_parts(E, ce.CE, sms), f"dma-pipeline {mode}: P {P}")
            check(sass["slow_path_instructions"] == 0, f"{name} takes an IEEE slow path: {sass}")
            copied = E * S * 16
            floor = mufu_floor_ms(pairs, sms) if math else None
            budget = timed[mode]["budget"]  # from the CUDA runtime, in the probe's run
            check(budget["registers"] <= 65536 // (256 * ce.RING_BLOCKS),
                  f"{name}: {budget}, built at the ring's launch bounds")
            dev_ms = None
            if not math:  # a call of tens of microseconds: its host cost shows back to back
                dev_ms = device_ms(run)
            ring_ms[mode] = dev_ms if dev_ms is not None else res["ms"]
            print(f"[10c math={math}] {mode} ({name}): {res['ms']:.3f} ms, P = {P} parts a "
                  f"block of {ce.CE}; "
                  + (f"MUFU floor {floor:.3f} ms ({floor / res['ms']:.3f} of the call); "
                     if math else
                     f"on the device alone {dev_ms:.4f} ms; copies {copied} bytes "
                     f"({copied / (dev_ms * 1e-3):.4e} B/s on the device); ")
                  + f"budget (CUDA runtime) {budget}; SASS {sass}")
            entries.append({"name": name, "route": "cuda", "source": ENTRY_PROBES,
                            "replaces": f"{DMA_SCRIPT}:{122 if mode == 'blockspec' else 177}",
                            **res, "launches": launches,
                            "launches_in": f"phase 10c: python -m nbody_torch.probe "
                                           f"dma-pipeline all --math {math}, mode {mode} (1 "
                                           "untimed + 12 timed calls)",
                            "E": E, "S": S, "dim": 3, "dtype": "float32", "parts": P,
                            "per_block": ce.CE, "copied_bytes": copied,
                            **({"mufu_floor_ms": floor, "mufu_share": floor / res["ms"]}
                               if math else {}),
                            "registers": budget["registers"],
                            "blocks_an_sm": budget["blocks_an_sm"],
                            **({"device_ms": dev_ms} if dev_ms is not None else {}), "sass": sass,
                            "us_per_entry": timed[mode]["us_per_entry"]})
        print(f"[10c math={math}] at one launch bound ({ce.RING_BLOCKS} blocks an SM, at most "
              f"{65536 // (256 * ce.RING_BLOCKS)} registers), ms "
              f"{'a call' if math else 'on the device alone'}: "
              + ", ".join(f"{m} {v:.4f}" for m, v in ring_ms.items())
              + "; ring / blockspec: " + ", ".join(
                  f"{m} {ring_ms[m] / ring_ms['blockspec']:.4f}" for m in ("manual2", "manual4")))
        if math:
            print(f"[10c math=1] the ideal rung at {ce.LADDER_BLOCKS} blocks an SM (10b, "
                  f"entry-overhead's inputs) {ideal_ms:.4f} ms, at {ce.RING_BLOCKS} (blockspec, "
                  f"the same E, S and grid on dma-pipeline's inputs) {ring_ms['blockspec']:.4f}")
        del recs, rec
    print(f"[10] phase 10 wall time {time.perf_counter() - t10:.0f} s")
    return entries


# -- phase 11: the trees' per-body walks (csrc/tree_walk.cu) ----------------

TREE_WALK = "nbody_torch/csrc/tree_walk.cu"
WALK_ROWS = 4096  # 11a: the sampled rows (whole warps) each walk kernel is held against its twin on
# 11a's configurations: (dim, dtype name) of a 2^20-body galaxy
WALK_CONFIGS = ((3, "float32"), (3, "float64"), (2, "float32"))
WALKS = {  # kernel -> (the softening of its terms, the nbody_tpu function it stands for)
    "bvh_walk_kernel": ("poly", "none: nbody_tpu/ops/bvh.py:129 compute_force "
                                "(lax.while_loop, no Pallas)"),
    "octree_walk_kernel": ("sqrt3", "none: nbody_tpu/ops/octree.py:198 compute_force "
                                    "(lax.while_loop, no Pallas)"),
}
MAC_OPS = 3  # a MAC test beyond its separation: two products (or a quotient) and a compare
# a lane's iterations by the twin's counts (weights): the BVH's node tests
# and two body slots a leaf visit, the octree's visits and drained bodies
# (no ADVANCE iteration)
WALK_ITERATIONS = {"bvh_walk_kernel": {"nodes": 1, "opened": 1, "leaves": 2},
                   "octree_walk_kernel": {"nodes": 1, "opened": 1, "pairs": 1}}
PACK = "octree_pack_kernel"
CADENCE_STEPS = 30  # 11c: 20 timed steps, so that --csv-total's 0.01 s resolves 0.0005 s/step


def walk_states(dev, n: int, dim: int, dtype):
    """A galaxy's two trees as the per-body paths build them: the BVH over
    the Hilbert-sorted state (its group path's sort and refit too), the
    octree's levels over the scalar box; and each walk's call, its twin's
    and its group path's force on the same tree, all in the walk's sorted
    order."""
    import dataclasses

    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh, bvh_group, octree, octree_group
    from nbody_torch.ops import cuda_tree_walk as tw
    from nbody_torch.ops.geometry import scalar_bounds

    cfg, state = build_model("galaxy", n, dim, dtype, device=dev)
    th, G, eps = cfg.theta, cfg.G, cfg.eps
    f64 = np.dtype(dtype) == np.float64
    st = bvh.hilbert_sort(state, eps)
    tree = bvh.build_tree(st.m, st.x, eps)
    lo, hi = scalar_bounds(state.x)
    levels, perm, ms, xs = octree.build_octree(state.m, state.x, lo, hi, octree.max_depth(n, dim))
    side = hi - lo

    def bvh_group_force():
        if f64:
            return bvh_group.compute_force_grouped(tree, st.m, st.x, th, G, eps)[0]
        return bvh_group.compute_force_grouped_windowed(tree, st.m, st.x, th, G, eps)[0]

    def octree_group_force():  # the step's group path, in the caller's order, then sorted
        out, _ = octree.octree_step_force(state, th, G, eps, levels.depth, list_path=f64)
        return out.a[perm]

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    level_arrays = (levels.mass, levels.com, levels.start, levels.count, levels.child_start,
                    levels.child_count, levels.parent)
    out_bytes = n * dim * np.dtype(dtype).itemsize

    def bvh_pack():
        return tw.bvh_records(tree.mm, tree.mx, tree.bw), tw.body_records(st.m, st.x)

    def octree_pack():
        return tw.octree_records_cuda(levels, ms, xs)
    return {
        "bvh_walk_kernel": dict(
            kern=lambda rows=None: tw.bvh_walk_cuda(tree.mm, tree.mx, tree.bw, tree.nlevels,
                                                     st.m, st.x, th, G, eps, rows),
            twin=lambda rows: tw.bvh_walk_torch(tree.mm, tree.mx, tree.bw, tree.nlevels, st.m,
                                                st.x, th, G, eps, rows, detail=True),
            pack=bvh_pack, group=bvh_group_force, m=st.m, x=st.x, G=G, eps=eps,
            nbytes=nbytes(*bvh_pack()) + out_bytes),
        "octree_walk_kernel": dict(
            kern=lambda rows=None: tw.octree_walk_cuda(levels, ms, xs, side, th, G, eps, rows),
            twin=lambda rows: tw.octree_walk_torch(levels, ms, xs, side, th, G, eps, rows,
                                                   detail=True),
            pack=octree_pack, pack_twin=lambda: tw.octree_records_torch(levels, ms, xs),
            pack_inputs_bytes=nbytes(*level_arrays, ms, xs),
            group=octree_group_force, m=ms, x=xs, G=G, eps=eps,
            nbytes=nbytes(*octree_pack()) + out_bytes),
    }


def rel_errors(a, ref) -> dict:
    """Per-body relative error |a - ref| / |ref|: median, p99, max."""
    import torch

    rel = ((a - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-300)).double()
    return {"median": torch.quantile(rel, 0.5).item(), "p99": torch.quantile(rel, 0.99).item(),
            "max": rel.max().item()}


def simt_efficiency(rows, iterations) -> float:
    """The mean over the sampled warps (rows: whole warps of 32 sorted
    rows, in any order) of their lanes' mean iterations over their most."""
    import torch

    per_lane = iterations[torch.argsort(rows)].double().view(-1, 32)
    return (per_lane.mean(1) / per_lane.amax(1).clamp_min(1)).mean().item()


def walk_measure(tag: str, name: str, walk: dict, n: int, dim: int, dtype_name: str,
                 walk_sass) -> dict:
    """11a, one walk on one galaxy (returns its measurement, and the pack
    kernel's or None): its call timed with CUDA events over the
    whole galaxy (a warm-up, then 3 calls), its
    records' pack alone (the octree's against its plain version, bit for
    bit), its twin on WALK_ROWS sampled rows (whole warps of 32 sorted
    rows, passed shuffled so that a lane's warp-mates differ from the whole
    call's) within TOL of each row's sum of |term|, the rows' own kernel
    call bit-equal to the whole call's rows, the interactions a body on the
    rows, the sampled warps' SIMT efficiency, the bound from them, the
    SASS's registers and spills, and the walk's and its group path's
    relative error against the exact sum on the rows."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca

    dev = walk["x"].device
    rng = np.random.default_rng(SEED)
    warps = rng.choice(n // 32, WALK_ROWS // 32, replace=False)
    rows = torch.from_numpy(rng.permutation((warps[:, None] * 32 + np.arange(32)).ravel()))
    rows = rows.to(dev)
    got = walk["kern"]()  # the warm-up launch
    kms = event_ms(walk["kern"], reps=3)
    pack_ms = event_ms(walk["pack"], reps=10)
    check(bool(torch.isfinite(got).all()), f"{tag} {name}: the walk is not finite")
    rows_ms, sub = event_ms(lambda: walk["kern"](rows), reps=1, keep=True)
    plain_ms, (ref, scale, counts) = event_ms(lambda: walk["twin"](rows), reps=1, keep=True)
    err, abs_err = scaled(got[rows], ref, scale)
    check(err <= TOL[dtype_name], f"{tag} {name}: scaled error {err:.3e} above {TOL[dtype_name]}")
    check(torch.equal(sub, got[rows]), f"{tag} {name}: the rows' call differs from the whole call")
    iterations = sum(w * counts[k] for k, w in WALK_ITERATIONS[name].items())
    simt = simt_efficiency(rows, iterations)
    per_body = {k: v.double().mean().item() for k, v in counts.items()}
    per_body["iterations"] = iterations.double().mean().item()
    pack = None
    if "pack_twin" in walk:
        got_pack = walk["pack"]()
        pack_plain_ms, want = event_ms(walk["pack_twin"], reps=1, keep=True)
        check(all(torch.equal(a, b) for a, b in zip(got_pack, want)),
              f"{tag} {PACK}: the records differ from their plain version")
        moved = walk["pack_inputs_bytes"] + sum(t.numel() * t.element_size() for t in got_pack)
        pack = {"ms": pack_ms, "plain_ms": pack_plain_ms, "max_abs_err": 0.0,
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": None, "nbytes": moved}
    softening = WALKS[name][0]
    ops = n * ((per_body["nodes"] + per_body["pairs"]) * flops_per_pair(dim, softening)
               + (per_body["nodes"] + per_body["opened"]) * MAC_OPS)
    peak = F64_FLOPS if dtype_name == "float64" else F32_FLOPS
    bound_ms, bound_by = bound(ops, 1, walk["nbytes"], peak)
    # the exact sum on the rows, in float64 with IEEE division
    m64, x64 = walk["m"].double(), walk["x"].double()
    exact = walk["G"] * ca.allpairs_block_cuda(x64[rows], m64, x64, walk["eps"], softening,
                                               exact=True)
    errs = {"walk": rel_errors(got[rows].double(), exact),
            "group": rel_errors(walk["group"]()[rows].double(), exact)}
    ctype = "double" if dtype_name == "float64" else "float"
    sass_rows = walk_sass.result(timeout=600)[1]
    keys = ("registers", "spill_stores", "spill_loads", "slow_path_instructions",
            "global_loads")

    def sass_of(kernel):
        return {k: next(r for r in sass_rows if kernel in r["kernel"]).get(k) for k in keys}
    sass = sass_of(f"::{name}<{ctype}, (int){dim}>(")
    print(f"[{tag}] {name}<{ctype}, {dim}>, {n} bodies: kernel {kms:.3f} ms a call with its "
          f"pack, the pack {pack_ms:.4f} ms alone "
          f"({rows_ms:.3f} ms on the {WALK_ROWS} rows), twin {plain_ms:.1f} ms on the rows; max "
          f"|kernel - twin| / sum|term| = {err:.3e} (limit {TOL[dtype_name]:g}); a body: "
          f"{per_body['nodes']:.1f} accepted nodes, {per_body['pairs']:.1f} direct pairs, "
          f"{per_body['opened']:.1f} opened nodes, {per_body['iterations']:.1f} iterations; "
          f"SIMT efficiency of the {WALK_ROWS // 32} sampled warps {simt:.4f}; bound "
          f"{bound_ms:.3f} ms ({bound_by}: {ops:.4e} operations, {walk['nbytes']} bytes of "
          f"records and rows); SASS {sass}; relative error against the exact sum, walk "
          f"{errs['walk']}, group path {errs['group']}")
    if pack is not None:
        pack["sass"] = sass_of(f"::{PACK}<{ctype}, (int){dim}>(")
        print(f"[{tag}] {PACK}<{ctype}, {dim}>: {pack_ms:.4f} ms, plain {pack['plain_ms']:.3f} "
              f"ms, records bit-equal; bound {pack['bound_ms']:.4f} ms (bytes: "
              f"{pack['nbytes']}); SASS {pack['sass']}")
    return {"ms": kms, "plain_ms": plain_ms, "plain_on_rows": WALK_ROWS, "rows_ms": rows_ms,
            "max_abs_err": abs_err, "max_scaled_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "operations": ops, "pack_ms": pack_ms,
            "simt_efficiency": simt,
            "per_body": per_body, "sass": sass, "rel_err_vs_exact": errs, "n": n, "dim": dim,
            "dtype": dtype_name, "records_bytes": walk["nbytes"]}, pack


def walk_phases(dev, big: int, walk_sass):
    """Phase 11: the trees' per-body walks (see the module docstring)."""
    import torch

    from nbody_torch.ops import cuda_tree_walk as tw

    t11 = time.perf_counter()
    # -- (a) each walk kernel against its twin on sampled rows at 2^20 -------
    measured = {name: {} for name in WALKS}
    pack = {}
    for dim, dtype_name in WALK_CONFIGS:
        walks = walk_states(dev, big, dim, np.dtype(dtype_name))
        for name in WALKS:
            measured[name][(dim, dtype_name)], packed = walk_measure(
                "11a", name, walks[name], big, dim, dtype_name, walk_sass)
            if packed:
                pack[(dim, dtype_name)] = packed
        del walks
        torch.cuda.empty_cache()

    # -- (b) the per-body CLI at full size: the walk kernel, never its twin --
    launches = {}
    for algorithm, name in (("octree", "octree_walk_kernel"), ("bvh", "bvh_walk_kernel")):
        launches[name] = cli_full_size(algorithm, 3, big, "11b",
                                       extra=("--traversal", "per-body"))
        check(launches[name][name] == 12, f"the per-body {algorithm} CLI launched {name} "
              f"{launches[name][name]} times, not 12")
        check(launches[name][PACK] == (12 if algorithm == "octree" else 0),
              f"the per-body {algorithm} CLI launched {PACK} {launches[name][PACK]} times")
        check(tw.twin_calls == {k: 0 for k in tw.twin_calls},
              f"the per-body {algorithm} CLI ran a twin: {tw.twin_calls}")

    # -- (c) s/step over 20 timed steps: the per-body paths, and the BVH's
    # cadence and refinement beside its default -----------------------------
    runs = {}
    for label, algorithm, extra in (
            ("octree per-body", "octree", ("--traversal", "per-body")),
            ("bvh per-body", "bvh", ("--traversal", "per-body")), ("bvh", "bvh", ()),
            ("bvh sort-every 4", "bvh", ("--sort-every", "4")),
            ("bvh refine-levels 1", "bvh", ("--refine-levels", "1"))):
        runs[label] = cli_full_size(algorithm, 3, big, "11c", extra=extra,
                                    steps=CADENCE_STEPS)["s_per_step"]
    print(f"[11c] {big} bodies 3-D float32, s/step over {CADENCE_STEPS - 10} timed steps: "
          + ", ".join(f"{k} {v:.4f}" for k, v in runs.items()))

    # -- (d) the refinement's kernels at the shapes --refine-levels 1 gives them
    refine = {dim: refine_phase(dev, big, dim) for dim in (3, 2)}
    print(f"[11] phase 11 wall time {time.perf_counter() - t11:.0f} s")

    entries = []
    for name, (_, replaces) in WALKS.items():
        algorithm = name.split("_")[0]
        entries.append({"name": name, "route": "cuda", "source": TREE_WALK, "replaces": replaces,
                        "launches": launches[name][name],
                        "launches_in": f"phase 11b: {big}-body 3-D {algorithm} --traversal "
                                       "per-body --csv-total",
                        **measured[name][(3, "float32")],
                        "float64_3d": measured[name][(3, "float64")],
                        "float32_2d": measured[name][(2, "float32")]})
    entries[0]["cli_s_per_step"] = runs
    entries[0]["bvh_refine_levels"] = refine
    entries.append({"name": PACK, "route": "cuda", "source": TREE_WALK,
                    "replaces": "none: packs the levels of nbody_tpu/ops/octree.py:111 "
                                "build_octree for octree_walk_kernel (no Pallas)",
                    "launches": launches["octree_walk_kernel"][PACK],
                    "launches_in": f"phase 11b: {big}-body 3-D octree --traversal per-body "
                                   "--csv-total",
                    **pack[(3, "float32")], "float64_3d": pack[(3, "float64")],
                    "float32_2d": pack[(2, "float32")]})
    return entries


REFINE_FALLBACK_ROWS = 4096  # 11d: the exact fallback's rows held against its twin


def refine_phase(dev, big: int, dim: int) -> dict:
    """Phase 11d: one BVH force evaluation of a 2^20-body galaxy at
    refine_levels 0 and 1 on the same tree, its kernel calls recorded. At
    R = 1 each recorded call is held against its twin (measure) and, if any
    tile fell back, the exact fallback on its first rows; at R = 0 each is
    timed again. Prints the counters, the calls' and kernels' ms side by
    side, and each force's error against the exact poly sum. Returns them
    by R."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh
    from nbody_torch.ops import bvh_group as bg
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg

    tag = f"11d {dim}-D"
    cfg, state = build_model("galaxy", big, dim, np.float32, device=dev)
    eps = cfg.eps
    state = bvh.hilbert_sort(state, eps)
    tree = bvh.build_tree(state.m, state.x, eps)
    wrappers = [attr for attr, _, _ in BVH_KERNELS.values()]
    ref = cfg.G * ca.allpairs_block_cuda(state.x, state.m, state.x, eps, "poly")
    out = {}
    for R in (0, 1):
        def call():
            return bg.compute_force_grouped_windowed(tree, state.m, state.x, cfg.theta, cfg.G,
                                                     eps, refine_levels=R)
        with recording(bg, [*wrappers, "allpairs_block_cuda"]) as recorded:
            a, info = call()
        counters = {k: int(v) for k, v in info.items() if not k.startswith("res_pass")}
        check(bool(torch.isfinite(a).all()), f"{tag} R={R}: the force is not finite")
        check(set(wrappers) <= set(recorded), f"{tag} R={R}: kernels called {sorted(recorded)}")
        check(counters["bad_entries"] == 0, f"{tag} R={R}: an entry addresses no tile")
        call_ms = event_ms(call, reps=3)
        kernels = {}
        for name, (attr, twin_attr, _) in BVH_KERNELS.items():
            kern, args = getattr(cg, attr), recorded[attr]
            if R:
                kernels[name] = measure(f"{tag} R=1", name, kern, getattr(cg, twin_attr), args,
                                        dim, "poly")
            else:
                kern(*args)
                kernels[name] = {"ms": event_ms(lambda: kern(*args), reps=5),
                                 "pairs": pairs_of(name, args)}
        fallback = None
        if "allpairs_block_cuda" in recorded:
            xi, mj, xj = recorded["allpairs_block_cuda"][:3]
            fb_ms, got = event_ms(lambda: ca.allpairs_block_cuda(xi, mj, xj, eps, "poly"),
                                  reps=3, keep=True)
            fallback = {"rows": xi.shape[0], "ms": fb_ms}
            if R:
                r = min(REFINE_FALLBACK_ROWS, xi.shape[0])
                err, _ = scaled(got[:r], ca.allpairs_block_torch(xi[:r], mj, xj, eps, "poly"),
                                ca.allpairs_block_abs_torch(xi[:r], mj, xj, eps, "poly"))
                fallback["max_scaled_err"] = err
                print(f"[{tag} R=1] the exact fallback on {xi.shape[0]} rows: {fb_ms:.3f} ms; "
                      f"its first {r} rows against the twin: max |diff| / sum|term| = "
                      f"{err:.3e} (limit {TOL['float32']:g})")
                check(err <= TOL["float32"], f"{tag}: the fallback differs from its twin")
        rel = ((a - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).double()
        error = {q: torch.quantile(rel, p).item() for q, p in (("median", 0.5), ("p99", 0.99))}
        out[R] = {"counters": counters, "call_ms": call_ms, "kernels": kernels,
                  "fallback": fallback, "rel_err_vs_exact": error}
        if R:
            diff = ((a - out[0].pop("a")).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).max()
            out[R]["max_rel_diff_vs_r0"] = diff.item()
        else:
            out[R]["a"] = a
    r0, r1 = out[0], out[1]
    print(f"[{tag}] {big}-body galaxy, refine_levels 0 -> 1 on one tree: the call "
          f"{r0['call_ms']:.3f} -> {r1['call_ms']:.3f} ms (CUDA events, 3 calls); "
          + "; ".join(f"{name} {r0['kernels'][name]['ms']:.3f} -> "
                      f"{r1['kernels'][name]['ms']:.3f} ms, pairs "
                      f"{r0['kernels'][name]['pairs']:.4e} -> {r1['kernels'][name]['pairs']:.4e}"
                      for name in BVH_KERNELS)
          + f"; fallback {r0['fallback']} -> {r1['fallback']}")
    print(f"[{tag}] counters R=0 {r0['counters']}")
    print(f"[{tag}] counters R=1 {r1['counters']}")
    print(f"[{tag}] per-body relative error against the exact poly sum: R=0 "
          f"{r0['rel_err_vs_exact']}, R=1 {r1['rel_err_vs_exact']}; max |a1 - a0| / |exact| "
          f"{r1['max_rel_diff_vs_r0']:.3e}")
    check(r1["rel_err_vs_exact"]["median"] <= 1e-3 and r1["rel_err_vs_exact"]["p99"] <= 1e-2,
          f"{tag}: the refined force is far from the direct sum")
    del ref, tree, state
    torch.cuda.empty_cache()
    return out


# -- phase 12: the replicated multi-device layouts (nbody_torch/parallel) ---
# 12a's CLI runs: (algorithm, dim, precision, n, ranks)
MESH_RUNS = (("all-pairs", 3, "float", 1 << 20, 2),
             ("octree", 3, "float", 1 << 20, 2), ("octree", 2, "float", 1 << 20, 2),
             ("bvh", 3, "float", 1 << 20, 2), ("bvh", 2, "float", 1 << 20, 2),
             ("octree", 3, "float", 1 << 20, 4), ("bvh", 3, "float", 1 << 20, 4),
             ("octree", 3, "double", 65536, 2))
# the kernels that every rank of a run must launch, by (algorithm, precision)
MESH_KERNELS = {("all-pairs", "float"): ("allpairs_block_kernel<float32, newton>",),
                ("octree", "float"): ("masked_eval_bits_kernel", "window_eval_interval_kernel",
                                      "entries_lohi_kernel", "entries_sum_kernel"),
                ("bvh", "float"): ("masked_eval_bits_kernel", "window_eval_nodemask_kernel",
                                   "entries_lohi_kernel", "entries_sum_kernel"),
                ("octree", "double"): ("group_eval_kernel<float64, sqrt3>",)}
# 12b: one step of each sharded path on 2 ranks against the single-device
# step, (algorithm, dim, precision, n); the limit on max |diff| / max |a|
MESH_PARITY = (("all-pairs", 3, "float", 1 << 20), ("octree", 3, "float", 1 << 20),
               ("octree", 2, "float", 1 << 20), ("bvh", 3, "float", 1 << 20),
               ("bvh", 2, "float", 1 << 20), ("octree", 3, "double", 65536))
MESH_LIMIT = {"float": 1e-5, "double": 1e-12}


def mesh_key(algorithm: str, dim: int, precision: str, n: int) -> str:
    """12a's single-device CLI flags of a run; with --mesh N, its mesh run's."""
    return " ".join(["-n", str(n), "-s", "12", "-d", str(dim), "--algorithm", algorithm,
                     "--workload", "galaxy", "--precision", precision, "--device", "cuda",
                     "--csv-total"])


def mesh_entry_name(algorithm: str, kernel: str) -> str:
    """The kernels line's name of a launch_counts key in a run of
    `algorithm`: the trees' far and entries kernels carry their softening."""
    if algorithm == "octree" and kernel in OCTREE_KERNELS:
        return f"{kernel}<sqrt3>"
    if algorithm == "bvh" and kernel in BVH_KERNELS and "nodemask" not in kernel:
        return f"{kernel}<poly>"
    return kernel


def mesh_phases(dev, single_steps: dict, mesh_steps: dict) -> dict:
    """Phase 12: the --mesh CLI at full size (12a), one step of each
    sharded path against the single-device step (12b), the backends
    (12c). single_steps maps a CLI argv (without --mesh) to its s/step
    where an earlier phase ran it, and gains the others; mesh_steps gains
    each 12a run's s/step, by MESH_RUNS entry. Returns the launches of
    12a's runs, summed over their ranks, by the kernels line's names."""
    import torch

    from nbody_torch import cli
    from nbody_torch.parallel import dryrun, launch, mesh

    t12 = time.perf_counter()
    cards = torch.cuda.device_count()

    def args_of(run):
        algorithm, dim, precision, n, world = run
        return cli.parse_args([*mesh_key(algorithm, dim, precision, n).split(), "--mesh",
                               str(world)])

    for algorithm, dim, precision, n, _ in MESH_RUNS:
        key = mesh_key(algorithm, dim, precision, n)
        if key not in single_steps:
            out = io.StringIO()
            check(cli.main(key.split(), out=out) == 0, f"single-device run {key} failed")
            single_steps[key] = float(out.getvalue().strip().splitlines()[1].split(",")[5]) / 2

    # the first run through the CLI's own --mesh entry (cli.run_mesh: the
    # spawn, rank 0's text, the ranks' digests checked); the others of each
    # rank count, and 12b's jobs, share one spawn (launch.run_jobs: the same
    # cli.mesh_rank on every rank), which saves ~10 s of start a run
    first = MESH_RUNS[0]
    out = io.StringIO()
    t0 = time.perf_counter()
    reports = {first: cli.run_mesh(args_of(first), dev, out)}
    check(out.getvalue() == reports[first][0]["text"], "run_mesh wrote another text than rank 0's")
    print(f"[12a] cli.run_mesh of the first run: {time.perf_counter() - t0:.1f} s with its "
          f"ranks' start")
    parity_jobs = [(dryrun.step_parity, (algorithm, n, dim, precision))
                   for algorithm, dim, precision, n in MESH_PARITY] + [(dryrun.dryrun_rank, ())]
    for world in sorted({run[4] for run in MESH_RUNS[1:]}):
        runs = [run for run in MESH_RUNS[1:] if run[4] == world]
        jobs = [(cli.mesh_rank, (args_of(run),)) for run in runs]
        t0 = time.perf_counter()
        ranks = launch.spawn(world, "cuda", launch.run_jobs,
                             jobs + (parity_jobs if world == 2 else []))
        for i, run in enumerate(runs):
            reports[run] = [rank[i] for rank in ranks]
        if world == 2:
            parity = [[rank[len(runs) + j] for rank in ranks] for j in range(len(parity_jobs))]
        print(f"[12a] one spawn of {world} ranks for {len(runs)} runs"
              f"{' and 12b' if world == 2 else ''}: {time.perf_counter() - t0:.1f} s")

    launches: dict[str, int] = {}
    for run in MESH_RUNS:
        algorithm, dim, precision, n, world = run
        key = mesh_key(algorithm, dim, precision, n)
        lines = reports[run][0]["text"].strip().splitlines()
        bits = "64" if precision == "double" else "32"
        check(len(lines) == 2 and lines[1].split(",")[:5] == [algorithm, str(dim), bits, "2",
                                                                 str(n)],
              f"--mesh {world} {key}: output {lines!r}")
        per_step = float(lines[1].split(",")[5]) / 2
        mesh_steps[run] = per_step
        kernels = MESH_KERNELS[(algorithm, precision)]
        for r in reports[run]:
            for kernel in kernels:
                check(r["launches"][kernel] > 0, f"--mesh {world} {key}: rank {r['rank']} did "
                      f"not launch {kernel} ({r['launches']})")
            for kernel, count in r["launches"].items():
                name = mesh_entry_name(algorithm, kernel)
                launches[name] = launches.get(name, 0) + count
        check(len({r["state_digest"] for r in reports[run]}) == 1, "ranks' final states differ")
        peak = ", ".join(f"{r['peak_memory'] / 2**30:.2f}" for r in reports[run])
        share = ("not a scaling figure: the ranks share the card" if cards < world
                 else "a card a rank")
        print(f"[12a] python -m nbody_torch.cli {key} --mesh {world}: {lines[1]} -> "
              f"{per_step:.4f} s/step beside {single_steps[key]:.4f} on one device "
              f"({world} ranks on {cards} card(s), {reports[run][0]['ranks_per_card']} a card: "
              f"{share}); backend {reports[run][0]['backend']}, devices "
              f"{sorted({r['device'] for r in reports[run]})}; peak memory a rank (GiB) "
              f"[{peak}]; launches summed over the ranks "
              f"{({k: sum(r['launches'][k] for r in reports[run]) for k in kernels})}")

    # -- (b) one step of each sharded path against the single-device step ---
    for (algorithm, dim, precision, n), ranks in zip(MESH_PARITY, parity):
        got = ranks[0]
        tag = f"{n}-body {dim}-D {precision} {algorithm}"
        check(all(r["state_digest"] == got["state_digest"] for r in ranks),
              f"12b {tag}: the ranks' states differ")
        check(got["same_order"], f"12b {tag}: the sharded step left the bodies in another order")
        aux, aux1 = got["aux"], got["aux_single"]
        exact = {k: v for k, v in aux.items() if k != "root_mass"}
        # the list path's root mass is an atomic index_add_ on the card, so its
        # order of addition varies from run to run: n * eps of the (positive)
        # masses' sum bounds the rounding of any order
        mass_tol = n * np.finfo(np.float64).eps
        mass_ok = "root_mass" not in aux or (
            aux["root_mass"] == aux1["root_mass"] if precision == "float" else
            abs(aux["root_mass"] - aux1["root_mass"]) <= mass_tol * abs(aux1["root_mass"]))
        print(f"[12b] {tag}, 2 ranks: one step's force against the single-device step's, "
              f"max |diff| / max |a| = {got['max_rel_err']:.3e} (limit "
              f"{MESH_LIMIT[precision]:.0e}), sum |diff| / sum |a| = {got['sum_rel_err']:.3e}; "
              f"aux {aux} beside {aux1}")
        check(got["max_rel_err"] <= MESH_LIMIT[precision], f"12b {tag}: forces differ")
        check(exact == {k: v for k, v in aux1.items() if k != "root_mass"} and mass_ok,
              f"12b {tag}: aux {aux} differs from the single-device {aux1}")
    dry = parity[-1]
    check(all(np.array_equal(r[k], dry[0][k]) for r in dry for k in dry[0]),
          "12b dry run: the ranks' positions differ")
    print(f"[12b] dry run (nbody_tpu's dryrun_multichip blocks) on 2 ranks over "
          f"{mesh.backend_for('cuda', 2)}: passed")

    # -- (c) the backends ----------------------------------------------------
    if cards >= 2:
        print(f"[12c] {cards} cards: the 2-rank runs above went over NCCL")
    else:
        one = launch.spawn(1, "cuda", dryrun.dryrun_rank)
        print(f"[12c] NCCL not exercised across cards: the machine has {cards} card; the runs "
              f"above went over gloo through host memory. A world of one over "
              f"{mesh.backend_for('cuda', 1)} set up its group and ran the dry run's "
              f"{', '.join(sorted(one[0]))} steps")
    print(f"[12] phase 12 wall time {time.perf_counter() - t12:.0f} s")
    return launches


# -- phase 13: the partitioned layout (nbody_torch/parallel/tree_partitioned) --
# 13a's CLI runs, 12 steps each on 4 ranks: (algorithm, dim, precision, n, mesh flags)
PART_RUNS = (("octree", 3, "float", 1 << 20, ("--mesh", "4")),
             ("bvh", 3, "float", 1 << 20, ("--mesh", "4")),
             ("octree", 3, "float", 1 << 20, ("--mesh", "2", "--mesh-tile", "2")),
             ("octree", 2, "float", 1 << 20, ("--mesh", "4")),
             ("octree", 3, "double", 65536, ("--mesh", "4")))
# the kernels that every rank of a float32 run must launch (rows 4 and 5)
PART_KERNELS = ("masked_eval_bits_kernel", "window_eval_interval_kernel")
# 13b: one step of each partitioned path on 4 ranks, a 65,536-body float32 galaxy:
# (algorithm, dim, the step's mesh)
PART_N = 65536
PART_PATHS = (("octree", 3, {}), ("bvh", 3, {}), ("octree", 2, {}), ("bvh", 2, {}),
              ("octree", 3, {"n_shards": 2, "tile_shards": 2}),
              ("bvh", 3, {"n_shards": 2, "tile_shards": 2}))
PART_SOFTENING = {"octree": "sqrt3", "bvh": "poly"}
# 13d: one step at 2^20 on 4 ranks whose masked_eval_bits_cuda calls are held
# against their twin: (algorithm, dim, n)
PART_FAR = (("octree", 3, 1 << 20), ("octree", 2, 1 << 20), ("bvh", 3, 1 << 20))
PART_FAR_TILES = 4  # tiles of each call held against the twin
PART_TORCH_LIMIT = 1e-4   # the kernels' step against the --kernel torch step, of max |a|
PART_DIRECT_LIMIT = 1e-5  # theta = 0 against the direct sum, of max |a|
PART_L2_LIMIT = 0.01      # theta = 0.5: relative L2 error against the direct sum


def part_argv(run) -> list[str]:
    algorithm, dim, precision, n, mesh = run
    return [*mesh_key(algorithm, dim, precision, n).split(), *mesh, "--mesh-layout",
            "partitioned"]


def part_name(algorithm: str, dim: int, kw: dict) -> str:
    grid = f"{kw['n_shards']}x{kw['tile_shards']}" if kw else "4"
    return f"{algorithm} {dim}-D on {grid} ranks"


def partitioned_phases(dev, single_steps: dict, mesh_steps: dict) -> dict:
    """Phase 13: the partitioned CLI at full size on 4 ranks (13a), one
    step of each partitioned path against its --kernel torch step, the
    direct sum at theta 0 and at theta 0.5, and the ring against the
    exchange (13b). Returns, by the kernels line's names, the launches of
    13a's float32 runs summed over their ranks."""
    import torch

    from nbody_torch import cli
    from nbody_torch.models import build_galaxy_model
    from nbody_torch.ops.cuda_allpairs import allpairs_block_cuda
    from nbody_torch.parallel import dryrun, launch

    t13 = time.perf_counter()
    cards = torch.cuda.device_count()
    first = PART_RUNS[0]
    out = io.StringIO()
    t0 = time.perf_counter()
    reports = {first: cli.run_mesh(cli.parse_args(part_argv(first)), dev, out)}
    check(out.getvalue() == reports[first][0]["text"], "run_mesh wrote another text than rank 0's")
    print(f"[13a] cli.run_mesh of {' '.join(part_argv(first))}: "
          f"{time.perf_counter() - t0:.1f} s with its ranks' start")

    # dt = 0: the step's new state keeps the positions its forces were taken at
    bodies = {}
    for dim in (2, 3):
        cfg, state = build_galaxy_model(PART_N, dim, np.float32, device=dev)
        bodies[dim] = cfg.replace(dt=0.0), state
    jobs, names = [], []
    for algorithm, dim, kw in PART_PATHS:
        cfg, state = bodies[dim]
        arrays = state.to_numpy()
        for tag, theta, extra in (("kernels", 0.5, {}), ("torch", 0.5, {"use_kernels": False}),
                                  ("theta0", 0.0, {})):
            jobs.append((dryrun.partitioned_step,
                         (algorithm, cfg.replace(theta=theta), arrays, {**kw, **extra})))
            names.append((algorithm, dim, part_name(algorithm, dim, kw), tag))
    cfg, state = bodies[3]
    jobs.append((dryrun.partitioned_step,
                 ("octree", cfg.replace(theta=0.5), state.to_numpy(), {"beyond_budget": 1})))
    names.append(("octree", 3, part_name("octree", 3, {}), "ring"))
    runs = list(PART_RUNS[1:])
    t0 = time.perf_counter()
    ranks = launch.spawn(4, "cuda", launch.run_jobs,
                         [(cli.mesh_rank, (cli.parse_args(part_argv(run)),)) for run in runs]
                         + jobs + [(far_field_check, path) for path in PART_FAR])
    for i, run in enumerate(runs):
        reports[run] = [rank[i] for rank in ranks]
    steps = {name: ranks[0][len(runs) + j] for j, name in enumerate(names)}
    far_checks = {path: [rank[len(runs) + len(jobs) + j] for rank in ranks]
                  for j, path in enumerate(PART_FAR)}
    print(f"[13a] one spawn of 4 ranks for {len(runs)} runs, 13b's {len(jobs)} steps and 13d's "
          f"{len(PART_FAR)}: {time.perf_counter() - t0:.1f} s")
    for j in range(len(runs), len(runs) + len(jobs)):
        check(all(r[j] is None or r[j][0]["x"].tobytes() == ranks[0][j][0]["x"].tobytes()
                  for r in ranks), f"13b {names[j - len(runs)]}: the ranks' states differ")

    # -- (a) the CLI runs ------------------------------------------------------
    replicated = {(run[0], run[1], run[2], run[3]): step for run, step in mesh_steps.items()
                  if run[4] == 4}
    launches: dict[str, dict] = {}
    for run in PART_RUNS:
        algorithm, dim, precision, n, mesh = run
        key = mesh_key(algorithm, dim, precision, n)
        lines = reports[run][0]["text"].strip().splitlines()
        bits = "64" if precision == "double" else "32"
        check(len(lines) == 2 and lines[1].split(",")[:5] == [algorithm, str(dim), bits, "2",
                                                                 str(n)],
              f"{' '.join(part_argv(run))}: output {lines!r}")
        per_step = float(lines[1].split(",")[5]) / 2
        check(len({r["state_digest"] for r in reports[run]}) == 1, "ranks' final states differ")
        summed = {k: sum(r["launches"][k] for r in reports[run]) for k in PART_KERNELS}
        if precision == "float":
            for r in reports[run]:
                for kernel in PART_KERNELS:
                    check(r["launches"][kernel] > 0, f"{' '.join(part_argv(run))}: rank "
                          f"{r['rank']} did not launch {kernel} ({r['launches']})")
            soft = PART_SOFTENING[algorithm]
            far = launches.setdefault(f"masked_eval_bits_kernel<{soft}>", {})
            far["partitioned_launches"] = far.get("partitioned_launches", 0) + \
                summed["masked_eval_bits_kernel"]
            window = launches.setdefault("window_eval_interval_kernel<sqrt3>", {})
            field = "partitioned_launches" if soft == "sqrt3" else "partitioned_poly_launches"
            window[field] = window.get(field, 0) + summed["window_eval_interval_kernel"]
        peak = ", ".join(f"{(r['peak_memory'] or 0) / 2**30:.2f}" for r in reports[run])
        beside = replicated.get((algorithm, dim, precision, n))
        print(f"[13a] python -m nbody_torch.cli {' '.join(part_argv(run))}: {lines[1]} -> "
              f"{per_step:.4f} s/step beside {single_steps.get(key, float('nan')):.4f} on one "
              f"device{'' if beside is None else f' and {beside:.4f} replicated on 4 ranks'} "
              f"(4 ranks on {cards} card(s): "
              f"{'not a scaling figure, the ranks share the card' if cards < 4 else 'a card a rank'}"
              f"); backend {reports[run][0]['backend']}; peak memory a rank (GiB) [{peak}]; "
              f"launches summed over the ranks {summed}")
    for entry in launches.values():
        entry["partitioned_launches_in"] = ("phase 13a: the partitioned --mesh CLI runs at "
                                            "2^20, float32, summed over their ranks")

    # -- (b) one step of each path: --kernel torch, the direct sum, the ring --
    for algorithm, dim, kw in PART_PATHS:
        name = part_name(algorithm, dim, kw)
        (k, aux), (t, _), (z, aux0) = (steps[(algorithm, dim, name, tag)]
                                       for tag in ("kernels", "torch", "theta0"))
        check(np.array_equal(k["x"], t["x"]), f"13b {name}: the torch step sorted otherwise")
        rel_torch = float(np.abs(k["a"] - t["a"]).max() / np.abs(t["a"]).max())
        cfg = bodies[dim][0]
        soft = PART_SOFTENING[algorithm]
        direct = {}
        for tag, st in (("theta0", z), ("kernels", k)):
            x = torch.tensor(st["x"], device=dev)
            m = torch.tensor(st["m"], device=dev)
            direct[tag] = (cfg.G * allpairs_block_cuda(x, m, x, cfg.eps, soft)).cpu().numpy()
        rel0 = float(np.abs(z["a"] - direct["theta0"]).max() / np.abs(direct["theta0"]).max())
        l2 = float(np.linalg.norm(k["a"] - direct["kernels"]) / np.linalg.norm(direct["kernels"]))
        print(f"[13b] {PART_N}-body {name}: kernels vs --kernel torch max |diff| / max |a| = "
              f"{rel_torch:.3e} (limit {PART_TORCH_LIMIT:g}); theta 0 vs the direct sum "
              f"{rel0:.3e} (limit {PART_DIRECT_LIMIT:g}, ring used {aux0['beyond_used_ring']}); "
              f"theta 0.5 relative L2 {l2:.3e} (limit {PART_L2_LIMIT:g}); beyond cells "
              f"{aux['beyond_halo_cells']}, ring used {aux['beyond_used_ring']}; comm {aux['comm']}")
        check(rel_torch <= PART_TORCH_LIMIT, f"13b {name}: the kernels' step differs from torch's")
        check(rel0 <= PART_DIRECT_LIMIT, f"13b {name}: theta 0 differs from the direct sum")
        check(l2 < PART_L2_LIMIT, f"13b {name}: theta 0.5 is far from the direct sum")
    name = part_name("octree", 3, {})
    (ex, aux_ex), (ring, aux_ring) = (steps[("octree", 3, name, tag)]
                                      for tag in ("kernels", "ring"))
    rel_ring = float(np.abs(ring["a"] - ex["a"]).max() / np.abs(ex["a"]).max())
    print(f"[13b] {PART_N}-body {name}, beyond_budget=1: ring used "
          f"{aux_ring['beyond_used_ring']} (exchange {aux_ex['beyond_used_ring']}), against the "
          f"exchange max |diff| / max |a| = {rel_ring:.3e} (limit 1e-4); comm bytes a rank "
          f"{aux_ring['comm_bytes_per_shard']} beside {aux_ex['comm_bytes_per_shard']}")
    check(aux_ring["beyond_used_ring"] and rel_ring <= 1e-4, "13b: the ring differs")

    # -- (c) the near field's call at the main path's shape, on the card alone --
    launches["window_eval_interval_kernel<sqrt3>"]["partitioned"] = near_field_call(dev)

    # -- (d) the far field and beyond sets' calls of a 2^20 step, on each rank --
    worst = {}
    for (algorithm, dim, n), per_rank in far_checks.items():
        soft = PART_SOFTENING[algorithm]
        for r, got in enumerate(per_rank):
            kinds = [c["kind"] for c in got["calls"]]
            for c in got["calls"]:
                print(f"[13d] {n}-body {algorithm} {dim}-D rank {r}: {c['kind']} call, "
                      f"{c['tiles']} tiles of {c['rows'] // c['tiles']} rows against "
                      f"{c['sources']} sources, "
                      f"tiles {c['sampled']} against masked_eval_bits_torch on the same packed "
                      f"words: max |kernel - plain| / sum|term| = {c['err']:.3e} (limit "
                      f"{TOL['float32']:g})")
                check(c["finite"] and c["err"] <= TOL["float32"], f"13d {algorithm} {dim}-D rank "
                      f"{r}: the {c['kind']} call differs from its twin")
                key = f"masked_eval_bits_kernel<{soft}>"
                worst[key] = max(worst.get(key, 0.0), c["err"])
            check(kinds[:1] == ["far"], f"13d {algorithm} {dim}-D rank {r}: no far-field call "
                  f"({kinds})")
        print(f"[13d] {n}-body {algorithm} {dim}-D: beyond cells "
              f"{per_rank[0]['beyond_halo_cells']}, ring used {per_rank[0]['ring']}; calls a rank "
              f"{[len(got['calls']) for got in per_rank]}")
    check(any(c["kind"] != "far" for per_rank in far_checks.values() for got in per_rank
              for c in got["calls"]), "13d: no beyond set was evaluated")
    for key, err in worst.items():
        launches.setdefault(key, {})["partitioned_max_scaled_err"] = err
    print(f"[13] phase 13 wall time {time.perf_counter() - t13:.0f} s")
    return launches


def near_field_call(dev, n: int = 1 << 20) -> dict:
    """13c: window_eval_interval_kernel as a middle body rank of 4 calls it
    at 2^20 (3-D galaxy, Morton-sorted): 262,144 rows against the 786,432
    of its window, every row the whole window, in tiles of 256 rows (the
    partitioned MAC's tile) and of 512 (the kernel's block, which the port
    passes), timed with CUDA events; both held on the first and the last
    512 rows against the plain twin on the same inputs, within 1e-5 of
    each row's sum of |term|; the pairs, the FLOP bound and the MUFU floor
    beside them."""
    import torch

    from nbody_torch.models import build_galaxy_model
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.ops.octree import max_depth, morton_sort, robust_quant_box
    from nbody_torch.parallel.tree_partitioned import TILE

    block = cg.ROWS_PER_BLOCK
    cfg, state = build_galaxy_model(n, 3, np.float32, device=dev)
    lo, hi = robust_quant_box(state.x)
    ms, xs, _, _ = morton_sort(state.m, state.x, lo, hi, max_depth(n, 3))
    nl = n // 4
    xi, me, xe = xs[nl:2 * nl].contiguous(), ms[:3 * nl].contiguous(), xs[:3 * nl].contiguous()
    pairs = nl * 3 * nl
    out, got = {"rows": nl, "window": 3 * nl, "pairs": pairs}, {}
    for tb in (TILE, block):
        nt = nl // tb
        zeros = torch.zeros(nt, dtype=torch.int32, device=dev)
        full = torch.full((nt,), 3 * nl, dtype=torch.int32, device=dev)

        def call():
            return cg.window_eval_interval_cuda(xi, me, xe, zeros, zeros, full, cfg.eps,
                                                3 * nl // tb, "sqrt3")

        got[tb] = call()
        out[f"ms_tile_{tb}"] = event_ms(call, reps=2)
    # the twin on one tile of `block` rows: the same window and interval
    errs = {}
    for where, rows in (("first", slice(0, block)), ("last", slice(nl - block, nl))):
        args = (xi[rows], me, xe, zeros[:1], zeros[:1], full[:1], cfg.eps, 3 * nl // block,
                "sqrt3")
        ref = cg.window_eval_interval_torch(*args)
        scale = cg.window_eval_interval_torch(*args, absolute=True)
        for tb in (TILE, block):
            errs[(where, tb)] = scaled(got[tb][rows], ref, scale)[0]
    err = max(errs.values())
    out["max_scaled_err"] = err
    out["bound_ms"], out["bound_by"] = bound(pairs, flops_per_pair(3, "sqrt3"),
                                             (nl + 3 * nl) * 16 + nl * 12)
    out["mufu_floor_ms"] = mufu_floor_ms(pairs, torch.cuda.get_device_properties(dev)
                                         .multi_processor_count)
    print(f"[13c] window_eval_interval_kernel at the partitioned shape ({nl} rows against "
          f"{3 * nl}, {pairs:.3e} pairs): tiles of {TILE} {out[f'ms_tile_{TILE}']:.1f} ms "
          f"({pairs / out[f'ms_tile_{TILE}'] * 1e3:.3e} pairs/s), of {block} "
          f"{out[f'ms_tile_{block}']:.1f} ms ({pairs / out[f'ms_tile_{block}'] * 1e3:.3e} "
          f"pairs/s); against the plain twin on the first and the last {block} rows, max "
          f"|kernel - plain| / sum|term| "
          f"{', '.join(f'{w} {tb}-row tiles {e:.2e}' for (w, tb), e in errs.items())} (limit "
          f"{TOL['float32']:g}); FLOP bound {out['bound_ms']:.3f} ms, MUFU floor "
          f"{out['mufu_floor_ms']:.3f} ms")
    check(err <= TOL["float32"], "13c: the window differs from its plain twin")
    return out


def far_field_check(group, algorithm: str, dim: int, n: int) -> dict:
    """13d, on each rank of a spawned group of 4: one step of the
    partitioned `algorithm` on an n-body float32 galaxy in `dim`-D, each
    masked_eval_bits_cuda call it makes (the far field first, then the
    beyond sets: the exchange, or the ring's rotations) held on
    PART_FAR_TILES of its tiles (the first, the last and two between)
    against masked_eval_bits_torch on the same rows, sources and packed
    words, as a fraction of each row's sum of |term|. Returns the calls'
    shapes, errors and whether their outputs were finite, the beyond cells
    and whether the ring ran."""
    import torch

    from nbody_torch.models import build_galaxy_model
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.parallel import tree_partitioned as tp

    calls = []
    kernel = tp.masked_eval_bits_cuda

    def held(xi, mj, xj, words, eps, softening):
        got = kernel(xi, mj, xj, words, eps, softening)
        ntiles = words.shape[0]
        tb = xi.shape[0] // ntiles
        pick = sorted({round(k * (ntiles - 1) / (PART_FAR_TILES - 1))
                       for k in range(PART_FAR_TILES)})
        rows = torch.cat([torch.arange(t * tb, (t + 1) * tb, device=xi.device) for t in pick])
        args = (xi[rows], mj, xj, words[pick], eps, softening)
        ref = cg.masked_eval_bits_torch(*args)
        scale = cg.masked_eval_bits_torch(*args, absolute=True)
        diff = (got[rows] - ref).abs() / scale.clamp_min(torch.finfo(scale.dtype).tiny)
        calls.append({"kind": "far" if not calls else "beyond", "tiles": ntiles,
                      "rows": xi.shape[0], "sources": xj.shape[0], "sampled": pick,
                      "err": diff.max().item(), "finite": bool(torch.isfinite(got).all())})
        return got

    make = tp.make_partitioned_octree_step if algorithm == "octree" \
        else tp.make_partitioned_bvh_step
    tp.masked_eval_bits_cuda = held
    try:
        cfg, state = build_galaxy_model(n, dim, np.float32, device=group.device)
        step = make(cfg, group)
        _, aux = step(step.shard(state), 0)
    finally:
        tp.masked_eval_bits_cuda = kernel
    ring = bool(aux["beyond_used_ring"])
    for c in calls[1:]:
        c["kind"] = "ring" if ring else "exchange"
    return {"calls": calls, "ring": ring, "beyond_halo_cells": int(aux["beyond_halo_cells"])}


# (mode, the mode it adds one feature to): the ladder's steps
LADDER_STEPS = (("sepmj", "ideal"), ("sel", "ideal"), ("when", "sel"), ("switch", "sel"),
                ("prod_noskip", "switch"), ("prod", "switch"))


def ladder_args(flags, math: bool, min_blocks: int) -> str:
    """entry_ladder_kernel's template arguments after DIM for a rung's
    flags (cuda_entry_probes.RUNGS), as cu++filt prints them: PACKED, SEL,
    WHEN, SWITCH, MATH, MIN_BLOCKS."""
    return ", ".join(f"(bool){int(v)}" for v in (*flags, math)) + f", (int){min_blocks}"


def probe_kernel_sass(rows, kernel: str, args: str, dim: int = 3) -> dict:
    """probe sass's row of an entry_probes.cu kernel: its instructions a
    pair in the hot loop, registers, spills and slow-path instructions."""
    key = f"::{kernel}<(int){dim}, {args}>(" if kernel == "entry_ladder_kernel" else \
        f"::{kernel}<{args}>("
    row = next(r for r in rows if key in r["kernel"])
    return {k: row.get(k) for k in ("instructions_per_pair", "registers", "spill_stores",
                                    "spill_loads", "loop_instructions", "mufu",
                                    "slow_path_instructions")}


def accuracy(tag: str, what: str, n: int, a, ref, dim: int = 3) -> None:
    """Per-body relative error of a tree force against an exact sum:
    median 1e-3 and p99 1e-2 at most (sanity bounds)."""
    import torch

    rel = ((a - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).double()
    med, p99 = (torch.quantile(rel, q).item() for q in (0.5, 0.99))
    print(f"[{tag}] {n}-body {dim}-D {what}, per-body relative error: median {med:.3e}, p99 "
          f"{p99:.3e}, max {rel.max().item():.3e} (limits: median 1e-3, p99 1e-2)")
    check(med <= 1e-3 and p99 <= 1e-2, f"{what}: far from the direct sum")


def clusters(n: int, dim: int):
    """Nine Gaussian clusters from a fixed seed, float32 (m, x)."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


def card_vs_cpu(tag: str, what: str, runs, limit: float = 1e-5) -> None:
    """Equal counters and forces within `limit` of sum |a|, card against CPU."""
    (ga, ginfo), (pa, pinfo) = runs
    rel = ((ga - pa).abs().sum() / pa.abs().sum()).item()
    print(f"[{tag}] {what}, card vs CPU twins: sum|diff| / sum|a| = {rel:.3e} (limit {limit:g}); "
          f"counters {'equal' if ginfo == pinfo else 'DIFFER'}: {ginfo}")
    check(ginfo == pinfo, f"counters differ: card {ginfo}, CPU {pinfo}")
    check(rel <= limit, "card and CPU forces differ")


def eps_of(dtype) -> float:
    import torch

    return float(torch.finfo(dtype).eps)


def event_ms(fn, reps: int, keep: bool = False):
    """Mean milliseconds of `reps` calls of fn, timed with CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    return (ms, out) if keep else ms


def read_state(path: str) -> np.ndarray:
    """The loadable state format (nbody_torch.io.saving): (n, 1 + 2*dim) float32."""
    with open(path, "rb") as f:
        n, dim = struct.unpack("<II", f.read(8))
        f.read(8)
        return np.frombuffer(f.read(), np.float32).reshape(n, 1 + 2 * dim)


if __name__ == "__main__":
    sys.exit(main())
