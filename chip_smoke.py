#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dplasma_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. build every hand-written kernel from the sources in this checkout
   (one nvcc per source, all started together) and print the build time;
2. hold each kernel against its plain PyTorch version on the card, on
   ragged shapes and on the shapes the main path gives it, and time the
   kernel, the plain version, the one PyTorch call that computes the same
   function (the yardstick only; the port never calls it in place of the
   kernel: K1's is ``torch.matmul``, K3's ``torch.linalg.lu_factor_ex``
   on cuSOLVER, K4's ``torch.geqrf`` on cuSOLVER) and the bound; K4 is
   also held to the reference's QR checks on each panel. K3 and K4 are
   one thread-block cluster per panel: the build logs their ptxas
   reports, each case logs the cluster geometry its launch used (and how
   many such clusters the card holds), K3 must be bitwise equal to its
   plain version (perm and factor) on every case, on all 32 main-path
   panels and on 100 back-to-back launches of the top panel, and two K4
   launches on one panel must be ``torch.equal``; the record keeps each
   main-path panel's row (M, kernel, cuSOLVER and bound ms) and the fit
   ms = a + b·M that splits the per-column chain from the part that grows
   with M;
   K1 is two kernels chosen per product by ``pallas_kernels.plan``
   (the tensor-core kernel, 3xTF32 for f32 with split-K in the launch,
   and the FFMA kernel for operands TMA cannot describe): each case logs
   its plan and the ptxas line of the instance it ran, two launches of a
   split-K product must be ``torch.equal``, and every distinct product of
   one spotrf, sgetrf, sgeqrf (recorded by running one factorization
   through the wrapper), sgetrf_ptgpanel and potrf_cyclic factorization
   is held to ``gemm_reference``, must take the tensor-core kernel, and
   is timed times its count beside ``torch.matmul`` and the 3xTF32 and
   FFMA bounds; every driver phase below also checks that no K1 product
   took the FFMA kernel;
3. the Cholesky path: ``testing_spotrf -N 16384 -t 1024 -x`` through the
   port's driver with K1 enabled. Kernel launch counts are zeroed just
   before and read just after; every update product of each
   factorization must have gone through K1 (2·nt − 3 = 29 launches), the
   -x checks must pass, and a small factorization on the card must agree
   with a float64 Cholesky on the host;
4. the LU path: ``testing_sgetrf -N 8192 -t 256 -x`` with K1 enabled and
   ``panel.kernel=pallas``, counts zeroed just before and read just
   after: every panel of each factorization through K3 (KT = 32) and
   every Schur product through K1 (2·KT − 3 = 61); the -x check must
   pass and a smaller factorization must reproduce its input
   (``a[perm] = L U``); then one factorization under ``torch.profiler``,
   its device time by kernel and the device's idle share (phases 3, 6, 9
   and 10 profile one factorization the same way);
5. ``testing_sgesv -N 8192 -t 256 -x`` (K3 and K1 on),
   ``testing_dgetrf -N 8192 -t 256 -x`` (default ``panel.kernel=auto``:
   cuSOLVER in FP64, no kernel by design), ``testing_dpotrf -N 8192 -t
   1024 -x`` (native FP64, no kernel by design) and ``testing_sgemm -N
   8192 -K 8192 -x`` through K1;
6. the QR path: ``testing_sgeqrf -N 8192 -t 256 -x`` with K1 enabled
   and ``panel.kernel=pallas``, counts zeroed just before and read just
   after: every panel of each factorization through K4 (KT = 32) and
   the K1 products ``ops/qr.py`` counts (11.5·KT − 24 = 344); the -x
   checks (|A-QR|, |I-Q'Q|) must pass and a smaller factorization must
   agree with a float64 QR on the host; then one factorization under
   ``torch.profiler``;
7. ``testing_sgels -N 8192 -t 256 -K 16 -x`` (K4 and K1 on),
   ``testing_sgeqrf -N 8192 -t 1024 -x`` (the reference ladder's size,
   default ``panel.kernel=auto``: cuSOLVER panels, no K4 by design) and
   ``testing_dgeqrf -N 8192 -t 256 -x`` (FP64, no kernel by design);
8. the f64-equivalent limb route (MCA ``dd_gemm=always``):
   ``testing_dpotrf -N 8192 -t 512 -x`` (the reference ladder's
   ``dpotrf_f64equiv`` size), then one direct ``ops.potrf.potrf`` call
   with the counts zeroed just before and read just after: every limb
   product through K2 (5·nt − 3 = 77) and no K1; a smaller
   factorization on the card against a float64 host Cholesky (numpy);
   one factorization under ``torch.profiler``; then
   ``testing_dgemm -N 8192 -K 8192 -x`` (one K2 launch per product)
   and ``testing_dposv -N 8192 -t 512 -x`` on the dd route and natively;
9. the distributed LU on a 2×2 virtual mesh:
   ``testing_sgetrf_ptgpanel -N 8192 -t 512 -p 2 -q 2 -x`` with K1
   enabled, counts zeroed just before and read just after: every panel
   broadcast along 'q' (KT·P = 32) and every winner-row shift along 'p'
   (KT·Q·(P−1) = 32) of each factorization through K5, 64 launches; the
   -x check must pass; one direct ``getrf_cyclic`` call on the ring
   route must be ``torch.equal`` (factor and perm) to the same call under
   ``ring.enable=off``; then one factorization under ``torch.profiler``;
10. the distributed Cholesky: ``potrf_cyclic`` at N=16384, nb=1024 on
   2×2 (the spotrf ladder's size) with K1 on its trailing products: 32
   K5 broadcasts per factorization, ``check_potrf`` on ``to_tile()``,
   the ring route ``torch.equal`` to the psum route, and its time beside
   spotrf's on one card.
11. the f64-equivalent LU and QR routes (``dd_gemm=always``):
   ``testing_dgetrf`` and ``testing_dgesv -N 8192 -t 256 -x``,
   ``testing_dgeqrf -N 8192 -t 1024 -x`` under the default settings
   (``auto``: the tree panels on the card) and on the chain panels, and
   ``testing_dgels -N 8192 -t 1024 -K 16 -x``, each beside native FP64,
   every timed run's K2 and K1 launches equal to the ops/lu.py and
   ops/qr.py counts; ``testing_dgetrf -N 8192 -t 1024`` (the ladder's
   ``dgetrf_f64equiv`` size) timed with its launches gated and its
   residual logged — there the LU's K = 1024 limb residuals leave the
   route's accuracy envelope, the reference's as the port's (PERF.md);
   one direct ``getrf_1d`` at nb=256 with ``panel.kernel=pallas``
   (counts zeroed just before and read just after: 32 K3 launches on the
   f32 seeds, the docstring's K2 count, no unfused product),
   ``torch.equal`` to the same call under ``lu.agg_depth=1``; direct
   ``geqrf`` calls at nb=1024 on the chain and tree panels with their K2
   and K1 counts and the -x checks; small factorizations against numpy
   float64; three factorizations under ``torch.profiler`` at N=4096;
12. the mixed-precision IR solvers (``ir.precision`` int8, bf16, f32 and
   f32x2): ``testing_dposv_ir -N 8192 -t 512 -K 4 -x``, ``testing_dgesv_ir
   -N 8192 -t 256 -K 4 -x`` (K3 panels) and ``testing_dgels_ir -M 8192 -N
   4096 -t 256 -K 4 -x`` (K4 panels) at every rung with K1 enabled, each
   beside native FP64 at its size: -x must pass on every run (an
   escalated solve too), f32 and f32x2 converge without escalation on
   all three, posv_ir on all four rungs, the int8 rung's guard is
   positive, every converged run's K2 launches are the ops/refine.py
   count and no limb product is unfused; the ladder's ``dposv_ir`` /
   ``dgesv_ir`` configuration (N=4096, nb=512, 4 right-hand sides) as
   direct calls at every rung, with the factor's time, share and K1
   launches (none under int8, whose updates ride the block-scaled int8
   GEMM; gels_ir at the driver's size keeps its narrow QR products on
   K1, fewer than at f32); one posv_ir f32x2 and one gesv_ir f32 solve
   under ``torch.profiler``;
13. the Cholesky inverse family and the Level-3 BLAS, norm and dd
   inverse drivers through ``drivers.main`` with K1 enabled, every
   kernel count zeroed just before each run and read just after:
   ``testing_spotri`` and ``testing_spoinv -N 16384 -t 1024 -x``,
   ``testing_strtri`` and ``testing_slauum`` at the same size (K1 per
   timed run: 31, 60, 30 and 1, ``ops/potrf.py``'s count),
   ``testing_ssymm``/``shemm``, ``ssyrk``/``sherk``,
   ``ssyr2k``/``sher2k``, ``strmm`` (1, 1, 2, 1) and ``testing_strsm
   -x`` (KT − 1 = 15) at M = N = K = 8192, nb = 512, ``testing_slange``,
   ``slanhe``, ``slansy``, ``slantr``, ``testing_slanm2`` (its -x
   residual against the SVD logged, not gated: the reference's 20 fixed
   power iterations miss its 1e-2 gate there), ``sgeadd``, ``stradd``
   and ``sprint`` at 8192, and ``testing_dpotri`` / ``testing_dpoinv -N
   8192 -t 512 -x`` under ``dd_gemm=always`` (K2 per timed run 95 and 172, no K1,
   none unfused) each beside native FP64; every -x check must pass and
   no K1 product may take the FFMA kernel; one library call beside each
   driver where there is one (``torch.cholesky_inverse``,
   ``torch.linalg.inv``, ``solve_triangular`` against I, ``matmul``,
   ``addmm``, ``matrix_norm``); every distinct K1 product of one direct
   trtri, lauum, symm, syrk, syr2k, trmm and trsm call recorded through
   the wrapper, held to ``gemm_reference`` on the tensor-core kernel
   and timed times its count beside ``torch.matmul`` and the 3xTF32
   bound; every distinct K2 product of one dd poinv held bitwise on its
   own operands and timed; one spoinv and one dd poinv under
   ``torch.profiler``.
14. the complex dtypes and the rest of the pivoted-LU family through
   ``drivers.main``, every kernel count zeroed just before each run and
   read just after: ``testing_{c,z}potrf -N 8192 -t 512 -x``,
   ``testing_{c,z}getrf`` and ``{c,z}geqrf -N 8192 -t 256 -x`` (chain
   panels: K3 and K4 are f32 kernels), ``{c,z}herk``, ``her2k``,
   ``hemm`` and ``trsm -x`` at 8192 with nb = 512 and ``{c,z}lanhe``, no
   kernel launched (K1 takes f32 and bf16 only, as in the reference);
   under ``dd_gemm=always`` ``testing_zpotrf -N 8192 -t 512 -x`` (the
   tile sweep: 46·nt − 16 = 720 K2 launches per factorization) and
   ``testing_zgetrf`` / ``zgeqrf -N 4096 -t 512 -x`` (156 and 136; N cut
   for time) beside native complex128; ``testing_sgetrf_incpiv``,
   ``sgetrf_qrf --criteria 1`` and ``sgesv_incpiv -N 8192 -t 512 -x``
   with K1 (120, 61 and 255 per timed run) and ``testing_dgetrf_incpiv
   -N 4096 -t 512 -x`` under dd (98 K2) beside native FP64; the -x
   residuals of zgetrf dd, dgetrf_incpiv dd and the f32 incpiv drivers
   at 8192 are logged, not gated (outside the route's accuracy envelope
   in the reference too, ROADMAP queue 3), the incpiv drivers' -x gated
   at N = 4096; one library
   call beside each driver (``torch.linalg.cholesky``,
   ``lu_factor_ex``, ``geqrf``, ``matmul``, ``addmm``,
   ``solve_triangular``, ``matrix_norm``, ``solve``); every distinct K2
   shape of one direct zpotrf, zgetrf, zgeqrf and dgetrf_incpiv dd call
   held bitwise against ``limb_product_base_reference`` on its own
   operands (the launches as derived, none unfused, no K1) and timed;
   every distinct K1 shape of one direct sgetrf_incpiv, getrs_incpiv and
   getrf_qrf call held within 1e-5 of ``gemm_reference`` on the
   tensor-core kernel and timed.
15. the hierarchical QR trees and the LDLᴴ / butterfly solvers through
   ``drivers.main`` with K1 enabled, every kernel count zeroed just
   before each run and read just after and each timed run's launches
   equal to the count derived from the trees (``ops/hqr.py``):
   ``testing_sgeqrf_hqr -N 8192 -t 512 -x`` with the default tree
   (greedy, a = 1: 1021 K1) and with ``--qr_a 4 --treeh 1`` (637),
   ``sgeqrf_systolic -x`` (1021), ``sgeqrf_rd -x`` (765), ``sgelqf_hqr``
   and ``sgelqf_systolic`` (1021), the four ``sunm*`` appliers at M = N
   = 8192 (768 each), ``testing_spivgen`` (94 trees checked),
   ``shetrf -x`` (15) and ``shebut -x`` (107); ``testing_zgeqrf_hqr`` and
   ``zhetrf -N 4096 -x`` (no kernel); under ``dd_gemm=always``
   ``testing_dgeqrf_hqr -x`` (253 K2) and ``dhetrf -x`` (21) at N = 4096
   (cut for time) beside native FP64; one library call beside each
   (``torch.geqrf``, ``ormqr``, ``linalg.ldl_factor`` — pivoted, not the
   same bits — and ``linalg.solve``); every distinct K1 product of one
   direct geqrf_param (both trees and the rd tree), gelqf_param,
   unmqr_param, unmlq_param, hetrf and hesv_rbt call held within 1e-5
   of ``gemm_reference`` on the tensor-core kernel and timed once,
   summed per path; every K2 launch of one dd geqrf_param and hetrf held
   bitwise and timed; hetrf's host share (its diagonal tiles' rank-1
   loops) and one shetrf under ``torch.profiler``.
16. the eigen/SVD chain with the port's two kernels of its own, KT (the
   tridiagonal eigenvalues by bisection on a shared tree, one launch a
   call) and KW (the SBR sweeps with b <= 128, one persistent launch a
   sweep): KT against its plain version on the (d, e) of an shetrd at
   N=8192 (also cast to f64) and a dhetrd at N=2048 (the plain version
   on the host over a sample of indices) and on edge cases (n = 1 and
   2, e = 0, Wilkinson's W₂₁⁺, a Jordan–Wielandt zero diagonal),
   ``torch.equal`` and within 2·eps·t_norm, ascending, timed beside its
   bound (the shared tree's Sturm steps at the card's division rate;
   the per-search bound beside it) and ``torch.linalg.eigvalsh`` of the
   dense tridiagonal; the gesvd drivers' Jordan–Wielandt tridiagonals the
   same, and their top K (the values gesvd asks KT for) launched alone,
   timed and held ``torch.equal`` to the full launch; KW replayed over
   every sweep it takes of one shetrd and one sgebrd (herm 64, 16, 4;
   bidiag 127, 31, 7) at N=8192 and of c, d and z at 2048, and of the
   Hermitian ladder of an shbrdt (herm 127, 31, 7) at N=8192, on random
   storage of that geometry, one launch a step, the plain version
   running the same step on the same input at the first, the last and
   every 389th step (every window slot within KW_COND eps kappa of the
   reference step; f64/c128 within 1e-11; f32/c64 a median distance to
   the step in twice the precision at most 4× the plain version's),
   then each sweep in one launch on the same input, timed and held
   ``torch.equal`` to its step-by-step launches (the narrow sweeps in
   both forms, warp and block, timed in the order A B B A, each run held
   bitwise); the KW
   sweeps of an shetrd and an sgebrd at N=512 on real data through KW
   and through the plain version, their spectra held to each other and
   the dense solver's and both timed (KW's ms and plain_ms); the window
   QR forms at the plain and K1 routes' shapes (``[geqrf]``); the six
   drivers through ``drivers.main`` with K1 on, one timed run each
   after their schedules are built (no warm-up run), every count zeroed
   just before each run and read just after and each timed run's K1 /
   K2 / KW / KT launches and KW steps held to the counts derived from
   ops/eig.py and the schedules: ``testing_sheev -x`` (the dense
   solver, no kernel),
   ``shetrd``, ``shbrdt -x``, ``sgebrd``, ``sgesvd -x``,
   ``sgebrd_ge2gb -x`` at N=8192 nb=256 and ``sgesvd -x`` on 8192×4096
   and 4096×8192, ``{d,c,z}hetrd`` and ``{d,c,z}gesvd -x`` at 2048,
   ``dhetrd`` / ``dgesvd -x`` under ``dd_gemm=always`` beside native
   FP64; two direct ``eig.heev(method="2stage")`` calls at 8192, their
   launches and spectrum held beside ``eigvalsh``, every distinct K1
   window product of the first held and timed; one heev 2stage and one
   sgesvd at 8192 with each stage (stage 1, the band scan, each sweep
   with its route and launches, KT) timed by CUDA events and the host
   clock, their launches held; one shetrd at N=2048
   under ``torch.profiler``; the band-storage Givens chase (``hbrdt`` on a
   ``BandMatrix``) at N=128, b=32, logged.
17. the out-of-HBM tiers, the GEMM dispatcher and the rest of the
   single-device catalogue, every count zeroed just before each call or
   driver run and read just after: the host link's rates (one pinned
   ``copy_`` of 1 GiB each way, the tiers' pitched copies of 512- and
   4096-wide blocks); ``potrf_lowmem`` on ``plghe`` made on the card and
   copied to pinned host memory, f32 at N=32768 and FP64 at N=16384, the
   budget a quarter of the matrix (nb 512, cw 6656 / 2560), held by
   ``check_potrf`` and against the in-core ``potrf`` (within N·u);
   ``getrf_lowmem`` at N=16384, nb=512 in 256 MiB under
   ``panel.kernel=pallas`` (every K3 panel recorded and held bitwise
   against ``lu_panel_reference``; A[perm] = L U within 60) and
   ``geqrf_lowmem`` (``check_qr``, orthogonality, R within 1e-3 of the
   in-core ``geqrf``'s); each logs its time, the bytes each way (equal
   to the schedule's sums), the GB/s over the call against the pinned
   copy's, the peak device memory against the budget and K1 / K3
   launches equal to the counts derived from the code, and every
   distinct K1 product is held to ``gemm_reference`` and timed;
   ``gemm_ex(algo="stream")`` at 16384³ (B=C=8, D=4: 128 K1 launches)
   beside ``blas3.gemm`` and ``plan_gemm``'s auto choice; the DTD
   drivers (``testing_{s,d}potrf_dtd``, ``sgemm_dtd`` 8192,
   ``sgeqrf_dtd``, ``sgetrf_incpiv_dtd`` 4096, the ``_untied`` at 2048)
   with -x beside ``testing_spotrf``; ``potrf_lapack`` on a
   Fortran-ordered f32 buffer at N=16384 (INFO 0, ``check_potrf``, the
   strict upper triangle untouched, INFO > 0 on a matrix that is not
   SPD); every ``pltmg`` type and ``latms`` at 2048 in s and z against
   the port's CPU result (bitwise for the hash and integer types, else
   within ``MG_TOL``; latms by its singular values); ``map_tiles`` and
   ``factor_info`` on the spotrf factor at 8192.
18. the rest of the block-cyclic catalogue on the 2x2 virtual mesh, f32
   with K1 on: ``potrf_cyclic`` U and ``potrs_cyclic`` L and U
   (nrhs = nb) at N=16384, nb=1024; ``getrs_cyclic`` after
   ``getrf_cyclic``, ``trsm_cyclic`` (L, N), ``gemm_cyclic`` and
   ``gemm_ex`` under the grid (SUMMA), ``herk``, ``trmm``, ``hemm``,
   ``her2k``, ``lauum``, ``trtri`` and ``potri_cyclic`` at 8192, nb=512;
   every (uplo, trans) corner of ``trsm_cyclic`` at 2048;
   ``geqrf_cyclic`` on an 8192 x 4096 matrix with the K5 ring (KT·P
   broadcasts), ``qr_t_factor`` + ``unmqr`` under ``check_qr`` and
   ``check_orthogonality``, the psum route ``torch.equal`` to it, one
   profile (at 4096 x 2048); ``heev_cyclic`` and ``gesvd_cyclic`` at 8192, nb=256 (KW and
   KT launches counted) within ``CYC_TOL`` of the single-device port's
   values. Each op once warm, then timed by CUDA events, every count
   zeroed just before its first timed call and read just after (K1
   launches equal to ``cyclic_k1_counts``, none on the FFMA kernel),
   the single-device port op on the same inputs timed beside it, the
   reference's check on the result, every distinct K1 product held to
   ``gemm_reference`` and timed; ``spmd_comm_model``'s bytes logged.
19. the drivers' instruments: the card's peaks probed with the
   reference's keys (K1's 3xTF32 rate, bf16 ``matmul``, ``torch._int_mm``,
   FP64 ``addmm``, all at 8192³; the limb route's bound from the int8
   rate; a device copy for HBM and the virtual mesh's transfers; a
   pinned copy; an empty launch) and written as a peaks file; then
   ``testing_spotrf -N 16384 -t 1024``, ``testing_sgetrf`` and
   ``sgeqrf -N 8192 -t 256`` (``panel.kernel=pallas``), ``testing_dpotrf
   -N 8192 -t 512`` under ``dd_gemm=always`` and natively,
   ``testing_dposv_ir`` at phase 12's size (f32) and
   ``testing_sgetrf_ptgpanel -N 8192 -t 512 -p 2 -q 2`` (``ring.enable=on``),
   each with -x once plain and once with ``--report --profile
   --phase-profile --peaks-file``, counts zeroed just before each and
   read just after: every report loads, each op carries its phase
   table, its comm model and a roofline entry, the phase rows are the
   ones ``sweep_rows`` / ``potrf_rows`` derive (held against the port's
   ledger by the CPU tests), coverage in (0, 1.05] (0 for the dd route,
   which has no span, as in the reference), no span above 1.05 of its
   bound, every kernel's launches per timed run equal to the plain
   run's, the ring probe's KT·P K5 broadcasts inside the attributed
   pass; spotrf with ``--jaxtrace`` (K1 events in the trace), and
   ``potrf_cyclic`` at N=16384, nb=1024 on 2×2 under
   ``phases.profiling()`` (one ``ring`` row, KT·P = 32 K5 in the probe).
20. the live and measured instruments: ``testing_spotrf -N 16384 -t
   1024 -x`` and ``testing_sgetrf_ptgpanel -N 8192 -t 512 -p 2 -q 2 -x``
   (``ring.enable=on``), each once plain and once with ``--devprof
   --telemetry --report --peaks-file`` (phase 19's peaks), the
   ptgpanel twice flagged: under ``devprof.backend`` ``auto`` and
   ``torch``; counts zeroed just before each run and read just after.
   spotrf's devprof entry is a ``torch`` capture whose K1 events equal
   one timed run's K1 launches, compute > 0, coverage <= 1.02; the
   ptgpanel's is synthetic with a note under ``auto`` and, under
   ``torch``, holds its K5 events in ``ici`` (as many as one timed run's
   K5 launches) with the ring classes reconciled ``==`` against the
   schedule (the psum and all_gather classes have no device op on one
   card: logged, not gated); the Prometheus file parses and its
   counters and gauges equal the report's metrics; the flight ring
   holds ``run_start``, ``op_start`` and ``op_done``; the provenance
   names torch, CUDA, ``backend: cuda``, the card and the commit (when
   the checkout has its own ``.git``); every kernel's launches per
   timed run are equal with and without the flags, and the best times
   of both are logged. Then 8 ``torch`` captures of 3 potrf runs each
   (N=16384, nb=1024), late in the process: every run's window holds
   its K1 launches as K1 events; the marker kernels at each edge of the
   capture are counted and logged.
21. the f64-equivalent route under the 2x2 grid and the resilience
   layer. (a) ``potrf_cyclic`` (L) in f64 under ``dd_gemm=always`` at
   N=8192, nb=512 (dpotrf_f64equiv's size): one warm-up (every
   distinct limb product recorded through the wrapper, held bitwise on
   its own operands and timed times its count), then the best of
   ``NRUNS_DDC`` calls timed by CUDA events, the counts zeroed just
   before the first and read after the last, K2's launches per call
   equal to ``cyclic_k2_launches`` (1276 at lookahead 1), none unfused,
   no K1; ``check_potrf`` and the
   single-device dd factor (``ops.potrf.potrf`` under ``always``)
   within ``DD_TOL``; beside it on the same card native FP64
   ``potrf_cyclic``, single-device dd and native ``potrf`` (its
   profile: ``tools/dd_profile.py --grid 2x2``).
   ``testing_dgetrf_ptgpanel -N 8192 -t 256 -p 2 -q 2 -x`` under dd
   (K2 per timed run = ``cyclic_k2_launches``) beside native FP64. The
   other 19 ops of the catalogue (potrf U, trsm, potrs, laswp, getrs,
   gemm_cyclic, SUMMA, herk, trmm, hemm, her2k, lauum, trtri, potri,
   geqrf, herbt, heev, ge2gb, gesvd) once native and once under dd at
   N=2048, nb=512 (first calls), each within ``DDC_TOL`` of its native
   run with its K2 launches counted as derived. (b) ``testing_spotrf
   -N 16384 -t 1024 -x --abft`` with K1 on and three plans, each
   primary attempt's K1 launches per run the 31 products of the
   17408-row bordered matrix (spotrf's 29 plus the border's two):
   ``--inject=bitflip@gemm:1:1`` at the default seed (logged: its
   flip lands below the ABFT floor); the same plan at the seed
   ``overflow_flip_seed`` derives (gated: bit 30 of a trailing-update
   product, finite itself but 2^128 times too large, so the factor
   goes non-finite: classed ``numerical``, ABFT flags it, the retry
   heals it); and ``--inject=bitflip@potrf:1:1`` at the seed
   ``silent_flip_seed`` derives from the floor formula (gated: a
   diagonal entry of the first tile factor moved by more than the
   floor and left finite: classed ``silent``, flagged by ABFT alone,
   healed on the retry). -x passes in all three. (c) ``testing_dpotrf
   -N 8192 -t 512 -x --abft`` under dd with no plan: one attempt, no
   rung, its time beside the plain dd run. (d) ``testing_spotrf -N
   4096 -t 512 -x --inject=reject@potrf:1:1``: the ladder walks to
   ``kernel_fallback`` (no K1 launch in the surviving attempt), and
   K1 is on again once the driver has closed; the same spotrf under
   ``--abft`` with K1's launch made to fail raises, K1 still on.
   (e) ``tracecat`` on phase 19's spotrf DTPUPROF1 file, merged with
   its report's phase table.
22. the serving layer (``dplasma_tpu_torch.serving``: the unbatched
   sweeps under ``torch.func.vmap``, K1 and K2 launched once per site
   for a batch), nb = 256, batches of 16, K1 on. (1) Batched K1: every
   product of one batched posv and gesv dispatch at n = 512, 1024 and
   2048, recorded through ``gemm_batched`` (its count equal to one
   element's, ``serving_k1_want``, every launch batched), replayed per
   product layout on random stacks: each element ``torch.equal`` to the
   2-D launch of that element, the stack within ``TOL`` of
   ``gemm_batched_reference``; timed beside a loop of 2-D launches, the
   plain version, ``torch.bmm`` / ``baddbmm`` and the bound; also a
   broadcast operand (batch stride 0) and an FFMA case. (2) Batched K2:
   the residuals of one batched posv_ir and gesv_ir at n = 512 and 1024
   (nrhs 4, 11 launches a dispatch, one a masked-loop residual),
   replayed bitwise to the plain batched version and to each element's
   2-D launch, timed beside a loop of 2-D launches and the int8 bound.
   (3) ``SolverService`` (``max_wait_ms`` 5): 128 f32 posv/gesv requests
   with n drawn from 384..2048 and nrhs 1..4, then 32 f64 posv_ir /
   gesv_ir requests (n 512..1024, ``ir.precision=f32``), then the f32
   traffic again on the warm cache: every future resolves and passes the
   service's gate, every IR request converges, each X within ``SV_TOL``
   of the port's unbatched solve of the same request; solves/s, p50/p99
   latency, the cache's hit rate and build seconds; one full dispatch of
   each op at bucket 1024 with its counts zeroed just before and read
   just after: K1 launches equal to one element's derived count, K2 one
   a masked-loop residual, every launch batched; one batch of 4 under
   ``nan@serving:1:1``: the struck request heals on its ladder (retry),
   its batch-mates resolve from the batch. (4) ``servebench`` (history
   and report in a temporary directory) at sizes 384..2048 over the four
   ops with an injected pass (a request remediated, none failed), then a
   short ``--soak --chaos`` whose conservation audit balances.

Phase 2 also holds K5 (the ring transfers) against its plain versions,
bitwise: n in {2, 3, 4} ranks, every root, 1 and 4 chunks, f32 and
bf16, a strided column-slice panel, the factorizations' own shapes, and
1000 back-to-back launches of each entry point on one flag buffer, each
checked; it times them against their bytes bound ((n+1)·S for a
broadcast of S bytes, 2·n·S for a shift), one PyTorch call that computes
the same transfer, the same moves by ``Tensor.copy_`` and the
masked-psum path. It holds K1 against its plain version on every
distinct product shape of phases 9 and 10 too (their slab-wide trailing
and lookahead products, with B strided as the bodies hand it over). Phase 2 also holds K2 (the dd route's recombine epilogue) against
its plain version, bitwise, on ragged shapes, a strided base, extreme levels
and every shape that one dpotrf factorization and one dgemm product give
it, and on every distinct limb product of one dgetrf dd and one dgeqrf dd
factorization at N=8192 (recorded through the wrapper, held on the path's
own operands, timed times its count), and every distinct limb product of
one f32x2 posv_ir, gesv_ir and gels_ir solve at phase 12's sizes (the
skinny residuals b − A x and projections Aᵀr, the nl = 5 whole-matrix
refinements at K = 8192: one fused launch each, none copied), and times
``torch._int_mm`` (the dd route's int8 products) in its four operand
layouts.

It prints the card's name and power limit, one JSON line describing
every kernel, and as its last line ``{"ok": true, "device": {...}}``.
A JSON record of the run also goes to ``chiprun_out/chip_smoke.json``.
Without CUDA, or without the rest of the repository beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import faulthandler
import functools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
FP32_FLOPS = 67e12          # CUDA-core FFMA
TF32_FLOPS = 495e12         # tensor cores
BF16_FLOPS = 989e12         # tensor cores
INT8_OPS = 1979e12          # tensor cores, dense int8
HBM_BYTES_S = 3.35e12

N_MAIN, NB_MAIN = 16384, 1024
N_LU, NB_LU = 8192, 256
N_QR, NB_QR = 8192, 256
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
N_DD, NB_DD = 8192, 512   # bench.py's dpotrf_f64equiv size (:18, :499)
# bench.py's dgetrf_f64equiv / dgeqrf_f64equiv size (:508-513, :644-647)
N_DDF, NB_DDF = 8192, 1024
NB_DDK3 = 256             # the dd getrf whose f32 seeds all pass K3's gate
N_DDF_PROF = N_DDF // 2   # the profiled dd getrf / geqrf (phase 11)
GRID = (2, 2)             # the distributed paths' P x Q virtual mesh
N_GT, NB_GT = 8192, 512   # testing_sgetrf_ptgpanel -N 8192 -t 512 -p 2 -q 2
N_PC, NB_PC = 16384, 1024  # potrf_cyclic at the spotrf ladder's size
# the IR drivers: posv_ir at the dpotrf_f64equiv size, gesv_ir at the
# widest nb K3's gate admits at M = 8192, gels_ir on an 8192 x 4096 matrix
# (K4), each with 4 right-hand sides (bench.py:230)
IR_RUNGS = ("int8", "bf16", "f32", "f32x2")
N_IR, NB_IR_POSV, NB_IR, M_IR_GELS, N_IR_GELS, NRHS_IR = (8192, 512, 256,
                                                          8192, 4096, 4)
# the ladder's dposv_ir / dgesv_ir configuration (bench.py:516-521)
N_LAD, NB_LAD = 4096, 512
DD_TOL = 1e-11      # dd factor vs a float64 host Cholesky, max|ΔL|/max|L|
K3_REPEATS = 100    # back-to-back K3 launches, each bitwise checked
K2_REPEATS = 1000   # back-to-back split K2 launches, each bitwise checked
# the run's own deadline, seconds: past it the stacks go to stderr and it
# exits non-zero (the whole run must end within 1200 s, the build included)
WATCHDOG_S = 1180
# K4 against its plain version: max|Δpacked|/max|packed| and max|Δtau|
# (the two sum in other orders); each panel's Q must pass the QR checks
K4_TOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def time_ms(torch, fn, reps=3):
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gemm_bound_ms(M, N, K, itemsize, has_c, peak_flops):
    """Least time for the product: the larger of its operations over the
    peak rate and its bytes (each input read once, the output written
    once) over the HBM rate."""
    flops = 2.0 * M * N * K
    nbytes = itemsize * (M * K + K * N + M * N * (2 if has_c else 1))
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main_path_products(n, nb):
    """(M, K, N) of every K1 product of one spotrf factorization at
    lookahead 1: the narrow product of column k (k >= 1) and the
    aggregated far product (k >= 2)."""
    nt = n // nb
    shapes = []
    for k in range(1, nt):
        m = n - k * nb
        shapes.append((m, nb, nb))
        if k >= 2:
            shapes.append((m, (k - 1) * nb, nb))
    return shapes


def cyclic_k1_products():
    """{path: [(label, M, K, N, b_view, count)]}: every K1 product of one
    factorization on the 2x2 grid at lookahead 1. Each rank's product is
    its whole slab (the reference's masked bodies), so per step and rank
    there is one trailing product and, but for the last step, one
    narrow lookahead product: 2·KT − 1 per rank, 124 on 2x2 at KT = 16.
    getrf_cyclic: l21 (mloc, nb) @ u12 (nb, nloc), and the lookahead's
    u12[:, c1], a column slice; potrf_cyclic: Lbelow (mloc, nb) @ W.T
    and @ Lk1.T, b.T views (``blas.dot(..., tb=True)``)."""
    P, Q = GRID
    out = {}
    for path, n, nb, view in (("sgetrf_ptgpanel", N_GT, NB_GT, False),
                              ("potrf_cyclic", N_PC, NB_PC, True)):
        kt = n // nb
        mloc, nloc = -(-kt // P) * nb, -(-kt // Q) * nb
        out[path] = [
            ("trailing", mloc, nb, nloc, view, kt * P * Q),
            ("lookahead", mloc, nb, nb, "cols" if view is False else view,
             (kt - 1) * P * Q)]
    return out


def nopiv_nodes(n, base=32):
    """Recursion nodes of one ``blas.getrf_nopiv_blocked`` of an n×n
    tile that split it (each a U solve, an L solve and a Schur
    product)."""
    if n <= base:
        return 0
    n1 = n // 2
    return 1 + nopiv_nodes(n1, base) + nopiv_nodes(n - n1, base)


def cyclic_k2_launches(op, P, Q, KT, lookahead=1, summa_steps=2, nb=8):
    """K2 launches of one call of the block-cyclic ``op`` on the P×Q grid
    under ``dd_gemm=always`` (f64), as the code derives them: every
    rank's product is one limb product (its slab-wide K = nb is far under
    the chunk depth ``dd.KC``); ``dd.potrf_f64`` makes 16 (``trtri_f64``'s
    two Newton steps of two, then three refinements of four),
    ``dd.trsm_f64`` two residuals and ``dd.trtri_f64`` four. Per rank and
    step: potrf L its tile factor, panel solve and trailing product, plus
    the lookahead's narrow product at steps k < KT − 1; getrf its two
    solves and the Schur product (the election LUs are vendor f64); the
    triangular solves a solve and a product (potrs and getrs two sweeps,
    trtri one against I, potri trtri then lauum); the BLAS-3 sweeps one
    product (her2k two); SUMMA lcm(P, Q)·summa_steps products a rank.
    The CholeskyQR2 panels of geqrf, herbt and ge2gb: per rank the Gram
    products, the solves and the applies (11 for a QR or LQ panel, 16
    for herbt's two-sided step), per axis group the two tile Choleskys,
    R2·R1 (33) and the TSQR-HR reconstruction's f64 LU of an nb tile
    (``getrf_nopiv_blocked``: two solves and a product a node, 5·
    ``nopiv_nodes(nb)``); geqrf's lookahead two products a rank and step. heev
    finishes on one device with no limb product (its second stage stays
    native FP64); gesvd adds the single-device SVD's stage 1 on the band
    (8·KT − 7)."""
    R = P * Q
    la = lookahead * (KT - 1)
    summa = R * (P * Q // math.gcd(P, Q)) * summa_steps
    grp = 33 + 5 * nopiv_nodes(nb)
    qr = KT * (11 * R + grp * Q)
    lq = (KT - 1) * (11 * R + grp * P)
    return {
        "potrf_L": R * (19 * KT + la), "getrf": R * (5 * KT + la),
        "potrf_U": 19 * R * KT, "trsm": 3 * R * KT, "potrs": 6 * R * KT,
        "getrs": 6 * R * KT, "laswp": 0, "gemm_cyclic": R * KT,
        "gemm_ex": summa, "herk": R * KT, "trmm": R * KT, "hemm": R * KT,
        "her2k": 2 * R * KT, "lauum": R * KT, "trtri": 3 * R * KT,
        "potri": 4 * R * KT, "geqrf": qr + 2 * R * la,
        "herbt": (KT - 1) * (16 * R + grp * Q),
        "heev": (KT - 1) * (16 * R + grp * Q),
        "ge2gb": qr + lq, "gesvd": qr + lq + 8 * KT - 7,
    }[op]


def lu_bound_ms(M, nb):
    """Least time for one LU panel: the larger of its LAWN-41 operations
    over the FP32 peak and its bytes (the panel read once, the packed
    factor and the int64 perm written once) over the HBM rate."""
    from dplasma_tpu_torch.utils import flops
    t_ops = flops.getrf(M, nb) / FP32_FLOPS
    t_bytes = (2 * M * nb * 4 + M * 8) / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main_path_panels(n, nb):
    """Heights of the KT panels of one sgetrf_1d factorization."""
    return [n - k * nb for k in range(n // nb)]


def fit_against_m(rows):
    """Least-squares fit of per-panel kernel time against the panel's
    height, ms = a + b·M: ``a`` is the part that does not grow with M
    (the chain of column steps; a / nb per column), ``b·M`` the part that
    does (the rows' updates)."""
    n = len(rows)
    mx = sum(r["M"] for r in rows) / n
    my = sum(r["ms"] for r in rows) / n
    sxx = sum((r["M"] - mx) ** 2 for r in rows)
    b = sum((r["M"] - mx) * (r["ms"] - my) for r in rows) / sxx
    return {"fixed_ms": my - b * mx, "ms_per_row": b}


def cluster_log(mod, M, nb):
    """The launch geometry of a K3/K4 panel (cluster size, rows per
    block, strip rows in shared memory, dynamic shared memory)."""
    return mod.launch_geometry(M, nb)._asdict()


def qr_bound_ms(M, nb):
    """Least time for one QR panel: the larger of its LAWN-41 operations
    over the FP32 peak and its bytes (the panel read once, the packed
    factor and the nb taus written once) over the HBM rate."""
    from dplasma_tpu_torch.utils import flops
    t_ops = flops.geqrf(M, nb) / FP32_FLOPS
    t_bytes = (2 * M * nb * 4 + nb * 4) / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dd_k2_shapes(n, nb):
    """(nl, M, N, K, base) of every K2 launch of one ``potrf_f64_blocked``
    factorization, in order. Column k (s = k·nb): the trailing product
    (k >= 1, K = s: the limb cache's views, its base a view of A), the
    diagonal tile's two refinement residuals (K = nb; bits 32 then 53:
    nl 5 then 8; base the scaled tile) and, but for the last column, the
    panel's two (n − s − nb rows, K = nb; base the slab below the tile, a
    view of A at k = 0): 5·nt − 3 in all."""
    nt = n // nb
    shapes = []
    for k in range(nt):
        m = n - k * nb
        if k:
            shapes.append((8, m, nb, k * nb, "cache"))
        shapes += [(5, nb, nb, nb, "dense"), (8, nb, nb, nb, "dense")]
        if k < nt - 1:
            kind = "view" if k == 0 else "dense"
            shapes += [(5, m - nb, nb, nb, kind), (8, m - nb, nb, nb, kind)]
    return shapes


def k2_bound_ms(nl, M, N, K, has_base):
    """Least time for one fused limb product, and what bounds it: its
    int8 operations (nl(nl+1)/2 limb pairs of 2·M·N·K) at the dense int8
    tensor-core peak, or its bytes (the nl limb planes of both operands,
    the scales and the base read once, the f64 output written once) over
    the HBM rate."""
    t_ops = nl * (nl + 1) // 2 * 2.0 * M * N * K / INT8_OPS
    nbytes = (nl * (M + N) * K + (16 if has_base else 8) * M * N
              + 8 * (M + N))
    t_bytes = nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def qr_k1_products(kt):
    """K1 products of one square geqrf at lookahead 1 and qr.agg_depth 4
    with every dimension >= 256, for kt a multiple of 4 (the count that
    the ops/qr.py docstring derives)."""
    return int(11.5 * kt - 24)


def agg_applies(kt, d):
    """Far applies of one square QR sweep of kt panels at lookahead 1
    with the far update flushed every d panels: at each step k <= kt − 3
    either a flush of d held panels (k mod d = d − 1) or the catch-up of
    the peeled column by the k mod d + 1 held ones — k mod d + 1 applies
    either way."""
    return sum(k % d + 1 for k in range(kt - 2))


def dd_lu_k2(kt):
    """K2 launches of one square dd ``getrf_1d`` of kt panels (the
    ops/lu.py docstring): 4 ``lu_ir`` residuals a panel, 3 a block apply
    (the U solve's 2 residuals and the Schur product), 2·kt − 3 applies
    whatever MCA ``lu.agg_depth`` says."""
    return 10 * kt - 9


def dd_qr_k2(kt, d, kind):
    """K2 launches of one square dd ``geqrf`` of kt panels (the ops/qr.py
    docstring): 27 a ``geqrt_f64`` panel (21 a ``geqrt_f64_tree`` one),
    19 for the last (square: a tree panel of nb rows, no V2 solve), 3 a
    compact-WY apply, a flush of d panels 3·d (its d − 1 ``wy_merge``s
    and one apply)."""
    per = 27 if kind == "chain" else 21
    return per * (kt - 1) + 19 + 3 * (kt - 1 + agg_applies(kt, d))


def nopiv_k1(n, base=32):
    """K1 products of one ``blas.getrf_nopiv_blocked`` of an n×n f32 tile
    (the dd QR panel's seed): one Schur product a recursion level, K1's
    when all of its dimensions are at least 256."""
    if n <= base:
        return 0
    n1 = n // 2
    return (int(min(n1, n - n1) >= 256) + nopiv_k1(n1, base)
            + nopiv_k1(n - n1, base))


def rel_fro(torch, got, want):
    want = want.double()
    return float(torch.linalg.norm(got.double() - want)
                 / torch.linalg.norm(want))


def k1_operand(torch, g, rows, cols, strides, dtype):
    """A (rows, cols) operand with the given element strides (one of them
    1), as a view of a larger random matrix where the other stride asks
    for it: a row-major slice (1 on the right) or a transposed view."""
    s0, s1 = strides
    if s1 == 1 and (s0 == cols or rows == 1):
        return torch.randn(rows, cols, device="cuda", generator=g).to(dtype)
    if s1 == 1:
        return torch.randn(rows, s0, device="cuda",
                           generator=g).to(dtype)[:, :cols]
    return torch.randn(cols, s1, device="cuda",
                       generator=g).to(dtype)[:, :rows].T


def k1_case(torch, pk, M, K, N, dtype, beta, b_view, seed, f64=False,
            a_strides=None, b_strides=None):
    """K1 against gemm_reference on one shape: (rel Frobenius error,
    max abs error, kernel ms, plain ms, torch.matmul ms, rel Frobenius
    error against a float64 product when ``f64``, the plan). ``b_view``:
    False a contiguous B, True a b.T view, ``"cols"`` a column slice of
    an 8·N-wide matrix (the getrf_cyclic lookahead's ``u12[:, c1]``);
    ``a_strides`` / ``b_strides``, where given, the element strides of a
    product recorded from a factorization."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if a_strides is not None:
        a = k1_operand(torch, g, M, K, a_strides, dtype)
    else:
        a = torch.randn(M, K, device="cuda", generator=g).to(dtype)
    if b_strides is not None:
        b = k1_operand(torch, g, K, N, b_strides, dtype)
    elif b_view == "cols":
        b = torch.randn(K, 8 * N, device="cuda",
                        generator=g).to(dtype)[:, N:2 * N]
    elif b_view:   # B as blas.dot(..., tb=True) hands it over: a b.T view
        b = torch.randn(N, K, device="cuda", generator=g).to(dtype).T
    else:
        b = torch.randn(K, N, device="cuda", generator=g).to(dtype)
    c = torch.randn(M, N, device="cuda", generator=g).to(dtype) \
        if beta != 0.0 else None
    alpha = 1.5 if beta != 0.0 else 1.0
    got = pk.gemm(a, b, c, alpha=alpha, beta=beta)
    want = pk.gemm_reference(a, b, c, alpha=alpha, beta=beta)
    torch.cuda.synchronize()
    check(got.dtype == dtype and tuple(got.shape) == (M, N),
          f"K1 output {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "K1 output not finite")
    rel = rel_fro(torch, got, want)
    mabs = float((got.float() - want.float()).abs().max())
    rel64 = None
    if f64:
        exact = alpha * (a.double() @ b.double())
        if c is not None:
            exact += beta * c.double()
        rel64 = rel_fro(torch, got, exact)
    k_ms = time_ms(torch, lambda: pk.gemm(a, b, c, alpha=alpha, beta=beta))
    p_ms = time_ms(torch, lambda: pk.gemm_reference(a, b, c, alpha=alpha,
                                                    beta=beta))
    if c is None:
        l_ms = time_ms(torch, lambda: torch.matmul(a, b))
    else:
        l_ms = time_ms(torch, lambda: torch.addmm(c, a, b, beta=beta,
                                                  alpha=alpha))
    return rel, mabs, k_ms, p_ms, l_ms, rel64, pk.plan_for(a, b)


def k1_ptxas(record, plan, dtype="float32", has_c=False):
    """The ptxas line (registers, spills) of the kernel instance a plan
    runs, from the build log (mangled names: ``k1_gemm_wgmma_kernel<T,
    A_K, B_K>``, ``k1_gemm_kernel<T, HAS_C, A_KFAST, B_NFAST>``)."""
    t = "f" if dtype == "float32" else "13__nv_bfloat16"
    if plan.kernel == "wgmma":
        want = (f"k1_gemm_wgmma_kernelI{t}Lb{int(plan.a_kmajor)}E"
                f"Lb{int(plan.b_kmajor)}E")
    else:
        want = (f"k1_gemm_kernelI{t}Lb{int(has_c)}E"
                f"Lb{int(plan.a_kmajor)}ELb{int(not plan.b_kmajor)}E")
    return next((v for k, v in record.get("ptxas_by_kernel", {}).items()
                 if k.startswith(want)), "not in the log")


def k1_path_sum(torch, pk, record, path, products, seed, cache=None):
    """Every distinct K1 product of one factorization of ``path`` (label,
    M, K, N, b_view, a_strides, b_strides, count), each held to
    gemm_reference and to the tensor-core kernel, timed, times its count:
    kernel, plain version, torch.matmul and both bounds (FP32 FFMA and
    3xTF32 operations). A product already in ``cache`` (a dict shared by
    several paths) is held and timed only the first time."""
    t = {"products": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
         "bound_ms": 0.0, "bound_ffma_ms": 0.0, "max_abs_err": 0.0,
         "rel_fro": 0.0, "rows": []}
    cache = {} if cache is None else cache
    for i, (label, M, K, N, view, a_s, b_s, cnt) in enumerate(products):
        key = (M, K, N, view, a_s and tuple(a_s), b_s and tuple(b_s))
        if key not in cache:
            rel, mabs, k_ms, p_ms, l_ms, _, plan = k1_case(
                torch, pk, M, K, N, torch.float32, 0.0, view,
                seed=seed + i, a_strides=a_s, b_strides=b_s)
            b_ffma, _ = gemm_bound_ms(M, N, K, 4, False, FP32_FLOPS)
            b_tc, _ = gemm_bound_ms(M, N, K, 4, False, TF32_FLOPS / 3)
            ptx = k1_ptxas(record, plan)
            log(f"[k1] {path} {label:12s} M={M:5d} K={K:5d} N={N:5d} "
                f"a{tuple(a_s) if a_s else ''} b={b_s or view} x{cnt}: "
                f"{plan.kernel} splits={plan.splits} "
                f"({plan.work_units} work units) rel_fro={rel:.3e} kernel "
                f"{k_ms:8.4f} ms  plain {p_ms:8.4f} ms  torch {l_ms:8.4f} "
                f"ms  bound {b_tc:7.4f} (3xTF32) / {b_ffma:7.4f} (FFMA) "
                f"ms; {ptx}")
            check(rel <= TOL["float32"],
                  f"K1 disagrees with gemm_reference on {path}'s {label} "
                  f"product {(M, K, N)}: rel_fro {rel:.3e}")
            check(plan.kernel == "wgmma",
                  f"{path}'s {label} product {(M, K, N)} would take the "
                  f"{plan.kernel} kernel, not the tensor-core kernel")
            cache[key] = (rel, mabs, k_ms, p_ms, l_ms, b_tc, b_ffma, plan,
                          ptx)
        rel, mabs, k_ms, p_ms, l_ms, b_tc, b_ffma, plan, ptx = cache[key]
        t["products"] += cnt
        for k_, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                      ("bound_ms", b_tc), ("bound_ffma_ms", b_ffma)):
            t[k_] += cnt * v
        t["max_abs_err"] = max(t["max_abs_err"], mabs)
        t["rel_fro"] = max(t["rel_fro"], rel)
        t["rows"].append({"label": label, "M": M, "K": K, "N": N,
                          "a_strides": a_s, "b_strides": b_s,
                          "b_view": view, "count": cnt,
                          "kernel": plan.kernel, "splits": plan.splits,
                          "ms": k_ms, "library_ms": l_ms, "rel_fro": rel,
                          "ptxas": ptx})
    log(f"[k1] one {path}'s {t['products']} products: kernel "
        f"{t['ms']:.3f} ms  plain {t['plain_ms']:.3f} ms  torch "
        f"{t['library_ms']:.3f} ms  bound {t['bound_ms']:.3f} ms (3xTF32) "
        f"/ {t['bound_ffma_ms']:.3f} ms (FFMA)  max rel_fro "
        f"{t['rel_fro']:.3e}")
    return t


def recorded_k1_products(torch, pk, run):
    """[(label, M, K, N, None, a_strides, b_strides, count)]: the K1
    products one call of ``run`` makes, recorded through the wrapper
    (each distinct shape and layout once, with its count)."""
    seen = {}
    orig = pk.gemm

    def recorder(a, b, c=None, **kw):
        key = (a.shape[0], a.shape[1], b.shape[1], tuple(a.stride()),
               tuple(b.stride()))
        seen[key] = seen.get(key, 0) + 1
        return orig(a, b, c, **kw)

    pk.gemm = recorder
    try:
        run()
        torch.cuda.synchronize()
    finally:
        pk.gemm = orig
    return [(f"{'aT' if a_s[0] == 1 else 'a'}"
             f"{'.bT' if b_s[0] == 1 else '.b'}", M, K, N, None, a_s, b_s,
             cnt) for (M, K, N, a_s, b_s), cnt in sorted(seen.items())]


def phase_build(record):
    from dplasma_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    took = _build.build_all()
    total = time.perf_counter() - t0
    per = json.dumps({k: round(v, 1) for k, v in took.items()})
    log(f"[build] kernels {sorted(_build.SOURCES)} built in {total:.1f} s "
        f"(per source: {per})")
    report = {}
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                       "Performance Loss")):
                log(f"[build] {name}: {line.strip()}")
                report.setdefault(name, []).append(line.strip())
    record["build_s"] = total
    record["ptxas"] = report
    # mangled entry name -> its ptxas line (registers, spills)
    by_kernel, entry = {}, None
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else None
            elif entry and ("registers" in line or "spill" in line):
                by_kernel[entry] = (by_kernel.get(entry, "") + " "
                                    + line.split(":", 1)[-1].strip()).strip()
    record["ptxas_by_kernel"] = {
        next((e[e.find(k):] for k in ("k1_gemm", "k2_") if k in e), e): v
        for e, v in by_kernel.items()}


def phase_k1(torch, pk, record):
    f32, bf16 = torch.float32, torch.bfloat16
    ragged = (1000, 777, 1030)
    vt = (1, 8192)       # sgeqrf's A = V^T view: unit stride along M
    cases = [
        # label, M, K, N, dtype, beta, b_view, a_strides, b_strides
        ("ragged f32 beta!=0", *ragged, f32, -0.5, False, None, None),
        ("ragged f32 beta=0", *ragged, f32, 0.0, False, None, None),
        ("ragged bf16 beta!=0", *ragged, bf16, -0.5, False, None, None),
        ("ragged bf16 beta=0", *ragged, bf16, 0.0, False, None, None),
        ("ragged f32 b.T view", *ragged, f32, 0.0, True, None, None),
        ("Gram V^T V 256x8192x256", 256, 8192, 256, f32, 0.0, False, vt,
         None),
        ("V^T C row-major B", 256, 8192, 2048, f32, 0.0, False, vt, None),
        ("b.T view beta!=0", 2048, 1024, 1024, f32, -0.5, True, None, None),
        ("column slice of B", 3072, 512, 512, f32, 0.0, "cols", None, None),
        ("bf16 beta!=0", 2048, 1024, 1024, bf16, -0.5, True, None, None),
        ("spotrf narrow (N-s)x1024x1024", N_MAIN - NB_MAIN, NB_MAIN,
         NB_MAIN, f32, 0.0, True, None, None),
        ("spotrf far (N-s)x(k*1024)x1024", N_MAIN - 8 * NB_MAIN,
         7 * NB_MAIN, NB_MAIN, f32, 0.0, True, None, None),
    ]
    rows = []
    for i, (label, M, K, N, dt, beta, view, a_s, b_s) in enumerate(cases):
        rel, mabs, k_ms, p_ms, l_ms, rel64, plan = k1_case(
            torch, pk, M, K, N, dt, beta, view, seed=100 + i, f64=True,
            a_strides=a_s, b_strides=b_s)
        tname = str(dt).split(".")[-1]
        peak = TF32_FLOPS / 3 if dt == f32 else BF16_FLOPS
        b_ms, b_by = gemm_bound_ms(M, N, K, 4 if dt == f32 else 2,
                                   beta != 0.0, peak)
        ok = rel <= TOL[tname]
        log(f"[k1] {label:32s} M={M:5d} K={K:5d} N={N:5d} {tname:8s} "
            f"{plan.kernel} splits={plan.splits} "
            f"rel_fro={rel:.3e} (tol {TOL[tname]:.0e}; vs f64 "
            f"{rel64:.3e}) "
            f"kernel {k_ms:9.3f} ms  plain {p_ms:9.3f} ms  "
            f"torch {l_ms:9.3f} ms  bound {b_ms:8.3f} ms ({b_by}); "
            f"{k1_ptxas(record, plan, tname, beta != 0.0)}")
        rows.append({"case": label, "M": M, "K": K, "N": N, "dtype": tname,
                     "beta": beta, "b_view": view, "a_strides": a_s,
                     "b_strides": b_s, "kernel": plan.kernel,
                     "splits": plan.splits, "rel_fro": rel,
                     "rel_fro_vs_f64": rel64,
                     "max_abs_err": mabs, "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "bound_ms": b_ms,
                     "bound_by": b_by})
        check(ok, f"K1 disagrees with gemm_reference on {label}: "
                  f"rel_fro {rel:.3e} > {TOL[tname]:.0e}")
    record["k1_cases"] = rows

    # two launches of a split-K product are bitwise equal
    g = torch.Generator(device="cuda").manual_seed(150)
    a = torch.randn(8192, 256, device="cuda", generator=g).T
    b = torch.randn(8192, 256, device="cuda", generator=g)
    plan = pk.plan_for(a, b)
    same = torch.equal(pk.matmul(a, b), pk.matmul(a, b))
    log(f"[k1] split-K Gram 256x8192x256 ({plan.splits} splits, "
        f"{plan.work_units} work units): two launches "
        f"{'torch.equal' if same else 'DIFFER'}")
    check(plan.splits > 1 and same, "two launches of a split-K product "
                                    "differ")

    # every product of one main-path factorization, timed in turn
    spotrf = [("narrow" if K == NB_MAIN else "far", M, K, N, True, None,
               None, 1) for M, K, N in main_path_products(N_MAIN, NB_MAIN)]
    tot = k1_path_sum(torch, pk, record, "spotrf", spotrf, 200)
    gflop = sum(2.0 * M * N * K for _, M, K, N, *_ in spotrf) / 1e9
    log(f"[k1] one spotrf's {len(spotrf)} products ({gflop:.0f} GFLOP): "
        f"{gflop / tot['ms']:.1f} TFLOP/s")
    record["k1_main_path"] = dict(tot, gflop=gflop)

    # every distinct product of one getrf_cyclic and one potrf_cyclic
    # factorization on the 2x2 grid, times its count
    cyc = {}
    for j, (path, prods) in enumerate(cyclic_k1_products().items()):
        cyc[path] = k1_path_sum(
            torch, pk, record, path,
            [(label, M, K, N, view, None, None, cnt)
             for label, M, K, N, view, cnt in prods], 300 + 10 * j)
    record["k1_cyclic_paths"] = cyc
    return tot, len(spotrf), cyc


def phase_k1_lu_qr(torch, pk, record):
    """Every distinct K1 product of one sgetrf and one sgeqrf
    factorization (N=8192, nb=256, ``panel.kernel=pallas``), recorded by
    running each once through the wrapper, timed times its count."""
    from dplasma_tpu_torch.ops import generators, lu, qr
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    out = {}
    for j, (path, n, nb, run) in enumerate((
            ("sgetrf", N_LU, NB_LU, lu.getrf_1d),
            ("sgeqrf", N_QR, NB_QR, qr.geqrf))):
        A = generators.plrnt(n, n, nb, nb, seed=3872)
        with cfg.override_scope({"panel.kernel": "pallas"}):
            prods = recorded_k1_products(torch, pk, lambda: run(A))
        want = 2 * (n // nb) - 3 if path == "sgetrf" \
            else qr_k1_products(n // nb)
        got = sum(p[-1] for p in prods)
        check(got == want, f"{path}: {got} K1 products recorded, want "
                           f"{want}")
        out[path] = k1_path_sum(torch, pk, record, path, prods, 400 + 50 * j)
        del A
    record["k1_lu_qr_paths"] = out
    return out


def with_cusolver(torch, fn, *args):
    """``fn(*args)`` with torch's linalg backend set to cuSOLVER by name
    (its default takes MAGMA for a tall ``lu_factor_ex``, ~10x slower)."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return fn(*args)
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def k3_case(torch, plu, a):
    """K3 against lu_panel_reference on one panel: (perm equal, max abs
    error (0: bitwise), max abs error / max|packed|, kernel ms, plain
    ms, cuSOLVER getrf ms)."""
    packed, perm = plu.lu_panel(a)
    want, wperm = plu.lu_panel_reference(a)
    torch.cuda.synchronize()
    check(packed.dtype == torch.float32 and packed.shape == a.shape
          and perm.shape == (a.shape[0],),
          f"K3 output {packed.dtype} {tuple(packed.shape)} "
          f"{tuple(perm.shape)}")
    check(bool(torch.isfinite(packed).all()), "K3 output not finite")
    perm_eq = bool(torch.equal(perm, wperm))
    mabs = float((packed - want).abs().max())
    rel = mabs / max(float(want.abs().max()), 1e-30)
    k_ms = time_ms(torch, lambda: plu.lu_panel(a))
    p_ms = time_ms(torch, lambda: plu.lu_panel_reference(a), reps=1)
    l_ms = time_ms(torch, lambda: with_cusolver(
        torch, torch.linalg.lu_factor_ex, a))
    return perm_eq, mabs, rel, k_ms, p_ms, l_ms


def tie_panel(torch, M, nb, seed):
    """An integer panel full of ties across the cluster's blocks, with
    column 0's largest |a| twice in the last block (the lower row wins)
    and row 0 in the first."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randint(-2, 3, (M, nb), device="cuda", generator=g).float()
    a[:, 0] = 1.0
    a[M - 3, 0], a[M - 1, 0] = 7.0, -7.0
    return a


def phase_k3(torch, plu, record):
    g = torch.Generator(device="cuda").manual_seed(300)
    tie = torch.randint(-2, 3, (2048, 64), device="cuda", generator=g)
    tie = tie.float()
    tie[:, 5] = 0.0          # a zero column: its L must come out 0
    last = tie_panel(torch, 4096, 64, 301)
    named = [("sgetrf top panel", (N_LU, NB_LU)),
             ("sgetrf middle panel", (N_LU // 2, NB_LU)),
             ("sgetrf last panel", (NB_LU, NB_LU)),
             ("M not k * cluster", (N_LU - 8, NB_LU)),
             ("ragged", (1000, 64)), ("tall narrow", (262144, 8)),
             ("ties + zero column", tie),
             ("tie, winner in last block", last)]
    rows = []
    for label, what in named:
        a = what if torch.is_tensor(what) else torch.randn(
            *what, device="cuda", generator=g)
        M, nb = a.shape
        perm_eq, mabs, rel, k_ms, p_ms, l_ms = k3_case(torch, plu, a)
        b_ms, b_by = lu_bound_ms(M, nb)
        geo = cluster_log(plu, M, nb)
        log(f"[k3] {label:26s} M={M:6d} nb={nb:3d} perm "
            f"{'equal' if perm_eq else 'DIFFERS'} max_abs_err={mabs:.3e} "
            f"(bitwise: 0)  kernel {k_ms:8.3f} ms  "
            f"plain {p_ms:8.3f} ms  cuSOLVER getrf {l_ms:8.3f} ms  "
            f"bound {b_ms:7.4f} ms ({b_by})  cluster {geo['cluster']} x "
            f"{geo['rows_per_block']} rows, smem rows {geo['smem_rows']}, "
            f"{geo['smem_bytes']} B")
        rows.append({"case": label, "M": M, "nb": nb, "perm_equal": perm_eq,
                     "max_abs_err": mabs, "rel_err": rel, "ms": k_ms,
                     "plain_ms": p_ms, "library_ms": l_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "geometry": geo})
        check(perm_eq, f"K3 perm differs from lu_panel_reference on {label}")
        check(mabs == 0.0, f"K3 is not bitwise equal to lu_panel_reference "
                           f"on {label}: max abs err {mabs:.3e}")
        if what is tie:
            check(bool((plu.lu_panel(tie)[0][6:, 5] == 0).all()),
                  "K3: the zero column's L is not 0")
        if what is last:
            check(int(plu.lu_panel(last)[1][0]) == 4096 - 3,
                  "K3: the tie in the last block did not go to its lower row")
    record["k3_cases"] = rows

    # back-to-back launches on the top panel, each bitwise equal to the
    # plain version (a memory-ordering fault between the cluster's SMs
    # would show as an occasional difference)
    a = torch.randn(N_LU, NB_LU, device="cuda", generator=g)
    want, wperm = plu.lu_panel_reference(a)
    outs = [plu.lu_panel(a) for _ in range(K3_REPEATS)]
    torch.cuda.synchronize()
    bad = [n for n, (p, q) in enumerate(outs)
           if not (torch.equal(p, want) and torch.equal(q, wperm))]
    log(f"[k3] {K3_REPEATS} back-to-back launches on the top panel: "
        f"{K3_REPEATS - len(bad)} bitwise equal to the plain version")
    check(not bad, f"K3 launches {bad} differ from the plain version")
    del outs

    # every panel of one main-path factorization, timed in turn
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "rel_err": 0.0}
    heights = main_path_panels(N_LU, NB_LU)
    per_panel = []
    for M in heights:
        a = torch.randn(M, NB_LU, device="cuda", generator=g)
        perm_eq, mabs, rel, k_ms, p_ms, l_ms = k3_case(torch, plu, a)
        check(perm_eq and mabs == 0.0,
              f"K3 disagrees on main-path panel {M}x{NB_LU}: perm "
              f"{perm_eq}, max abs err {mabs:.3e}")
        per_panel.append({"M": M, "ms": k_ms, "library_ms": l_ms,
                          "bound_ms": lu_bound_ms(M, NB_LU)[0],
                          "cluster": plu.launch_geometry(M, NB_LU).cluster})
        tot["ms"] += k_ms
        tot["plain_ms"] += p_ms
        tot["library_ms"] += l_ms
        tot["bound_ms"] += lu_bound_ms(M, NB_LU)[0]
        tot["max_abs_err"] = max(tot["max_abs_err"], mabs)
        tot["rel_err"] = max(tot["rel_err"], rel)
    tot["max_abs_err"] = max([tot["max_abs_err"]]
                             + [r["max_abs_err"] for r in rows])
    log(f"[k3] one sgetrf's {len(heights)} panels ({N_LU}..{NB_LU} x "
        f"{NB_LU}): kernel {tot['ms']:.3f} ms  plain {tot['plain_ms']:.3f} "
        f"ms  cuSOLVER getrf {tot['library_ms']:.3f} ms  bound "
        f"{tot['bound_ms']:.3f} ms  max abs err {tot['max_abs_err']:.3e}")
    fit = fit_against_m(per_panel)
    log_panels("k3", per_panel, fit, NB_LU, "cuSOLVER getrf")
    record["k3_main_path"] = dict(tot, panels=len(heights), rows=per_panel,
                                  fit=fit)
    return tot, len(heights)


def log_panels(tag, per_panel, fit, nb, lib):
    for r in per_panel:
        log(f"[{tag}]   panel M={r['M']:5d} cluster {r['cluster']:2d}: kernel "
            f"{r['ms']:.4f} ms  {lib} {r['library_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms")
    log(f"[{tag}] fit ms = a + b*M over the panels: a = "
        f"{fit['fixed_ms']:.4f} ms ({1e3 * fit['fixed_ms'] / nb:.3f} us per "
        f"column), b = {1e6 * fit['ms_per_row']:.4f} ns per row")


def k4_case(torch, pqr, a):
    """K4 against geqrt_panel_reference on one panel: dict of the max
    abs error, the error relative to max|packed|, the tau error, the
    QR checks of the Q rebuilt from K4's output, and the times of the
    kernel, the plain version and cuSOLVER's geqrf."""
    from dplasma_tpu_torch.descriptors import TileMatrix
    from dplasma_tpu_torch.ops import checks
    packed, taus = pqr.geqrt_panel_packed(a)
    want, wtau = pqr.geqrt_panel_reference(a)
    torch.cuda.synchronize()
    M, nb = a.shape
    check(packed.dtype == torch.float32 and packed.shape == a.shape
          and taus.shape == (nb,),
          f"K4 output {packed.dtype} {tuple(packed.shape)} "
          f"{tuple(taus.shape)}")
    check(bool(torch.isfinite(packed).all() and torch.isfinite(taus).all()),
          "K4 output not finite")
    mabs = float((packed - want).abs().max())
    rel = mabs / max(float(want.abs().max()), 1e-30)
    dtau = float((taus - wtau).abs().max())
    # Q's first nb columns from the compact-WY form: Q = I - V T V^T
    _, v, T = pqr.geqrt_panel(a)
    q = torch.eye(M, nb, device=a.device) - v @ (T @ v[:nb].T)
    qr_res = checks.check_qr(TileMatrix.from_dense(a, nb, nb), q,
                             torch.triu(packed[:nb]))[0]
    orth_res = checks.check_orthogonality(q)[0]
    return {"max_abs_err": mabs, "rel_err": rel, "tau_err": dtau,
            "qr_residual": qr_res, "orth_residual": orth_res,
            "ms": time_ms(torch, lambda: pqr.geqrt_panel_packed(a)),
            "plain_ms": time_ms(torch,
                                lambda: pqr.geqrt_panel_reference(a),
                                reps=1),
            "library_ms": time_ms(torch, lambda: with_cusolver(
                torch, torch.geqrf, a))}


def _k4_ok(r):
    return (r["rel_err"] <= K4_TOL and r["tau_err"] <= K4_TOL
            and r["qr_residual"] < 60 and r["orth_residual"] < 60)


def phase_k4(torch, pqr, record):
    g = torch.Generator(device="cuda").manual_seed(400)
    zero = torch.randn(2048, 64, device="cuda", generator=g)
    zero[:, 5] = 0.0         # a zero column: tau 0, its v 0
    strided = torch.randn(512, 3000, device="cuda", generator=g)[64:128].T
    named = [("ragged", (1000, 64)), ("middle panel", (4096, NB_QR)),
             ("sgeqrf top panel", (N_QR, NB_QR)),
             ("M not k * cluster", (N_QR - 8, NB_QR)),
             ("square (tau = 2)", (NB_QR, NB_QR)),
             ("tall narrow", (262144, 8)), ("zero column", zero),
             ("strided (a.T view)", strided),
             ("tie panel", tie_panel(torch, 4096, 64, 401))]
    rows = []
    for label, what in named:
        a = what if torch.is_tensor(what) else torch.randn(
            *what, device="cuda", generator=g)
        M, nb = a.shape
        r = k4_case(torch, pqr, a)
        b_ms, b_by = qr_bound_ms(M, nb)
        geo = cluster_log(pqr, M, nb)
        p1, t1 = pqr.geqrt_panel_packed(a)
        p2, t2 = pqr.geqrt_panel_packed(a)
        same = bool(torch.equal(p1, p2) and torch.equal(t1, t2))
        log(f"[k4] {label:20s} M={M:6d} nb={nb:3d} rel={r['rel_err']:.3e} "
            f"tau={r['tau_err']:.3e} (tol {K4_TOL:.0e}) |A-QR| "
            f"{r['qr_residual']:.2f} |I-Q'Q| {r['orth_residual']:.2f}  "
            f"two launches {'equal' if same else 'DIFFER'}  "
            f"kernel {r['ms']:8.3f} ms  plain {r['plain_ms']:8.3f} ms  "
            f"cuSOLVER geqrf {r['library_ms']:8.3f} ms  bound "
            f"{b_ms:7.4f} ms ({b_by})  cluster {geo['cluster']} x "
            f"{geo['rows_per_block']} rows, smem rows {geo['smem_rows']}, "
            f"{geo['smem_bytes']} B")
        rows.append(dict(r, case=label, M=M, nb=nb, bound_ms=b_ms,
                         bound_by=b_by, geometry=geo, repeat_equal=same))
        check(_k4_ok(r), f"K4 disagrees with geqrt_panel_reference on "
                         f"{label}: {r}")
        check(same, f"K4: two launches on {label} differ")
        if label.startswith("square"):
            taus = pqr.geqrt_panel_packed(a)[1]
            check(float(taus[-1]) == 2.0, "K4: the square panel's last "
                  f"tau is {float(taus[-1])}, not 2")
        if what is zero:
            packed, taus = pqr.geqrt_panel_packed(zero)
            check(float(taus[5]) == 0.0 and bool((packed[6:, 5] == 0).all()),
                  "K4: the zero column's tau or v is not 0")
    record["k4_cases"] = rows

    # torch's default linalg backend against cuSOLVER asked for by name,
    # for the two vendor QRs the port calls (geqrf_packed, the TSQR leaves)
    top = torch.randn(N_QR, NB_QR, device="cuda", generator=g)
    leaves = torch.randn(16, 2 * NB_QR, NB_QR, device="cuda", generator=g)
    backends = {
        "geqrf 8192x256 default": time_ms(torch, lambda: torch.geqrf(top)),
        "geqrf 8192x256 cusolver": time_ms(torch, lambda: with_cusolver(
            torch, torch.geqrf, top)),
        "qr 16x512x256 default": time_ms(
            torch, lambda: torch.linalg.qr(leaves)),
        "qr 16x512x256 cusolver": time_ms(torch, lambda: with_cusolver(
            torch, torch.linalg.qr, leaves))}
    log("[k4] linalg backends: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in backends.items()))
    record["linalg_backends_ms"] = backends

    # every panel of one main-path factorization, timed in turn
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "rel_err": 0.0, "tau_err": 0.0,
           "qr_residual": 0.0, "orth_residual": 0.0}
    heights = main_path_panels(N_QR, NB_QR)
    per_panel = []
    for M in heights:
        a = torch.randn(M, NB_QR, device="cuda", generator=g)
        r = k4_case(torch, pqr, a)
        check(_k4_ok(r), f"K4 disagrees on main-path panel {M}x{NB_QR}: {r}")
        per_panel.append({"M": M, "ms": r["ms"],
                          "library_ms": r["library_ms"],
                          "bound_ms": qr_bound_ms(M, NB_QR)[0],
                          "cluster": pqr.launch_geometry(M, NB_QR).cluster})
        for key in ("ms", "plain_ms", "library_ms"):
            tot[key] += r[key]
        tot["bound_ms"] += qr_bound_ms(M, NB_QR)[0]
        for key in ("max_abs_err", "rel_err", "tau_err", "qr_residual",
                    "orth_residual"):
            tot[key] = max(tot[key], r[key])
    tot["max_abs_err"] = max([tot["max_abs_err"]]
                             + [r["max_abs_err"] for r in rows])
    log(f"[k4] one sgeqrf's {len(heights)} panels ({N_QR}..{NB_QR} x "
        f"{NB_QR}): kernel {tot['ms']:.3f} ms  plain {tot['plain_ms']:.3f} "
        f"ms  cuSOLVER geqrf {tot['library_ms']:.3f} ms  bound "
        f"{tot['bound_ms']:.3f} ms  max abs err {tot['max_abs_err']:.3e}  "
        f"max |A-QR| {tot['qr_residual']:.2f} |I-Q'Q| "
        f"{tot['orth_residual']:.2f}")
    fit = fit_against_m(per_panel)
    log_panels("k4", per_panel, fit, NB_QR, "cuSOLVER geqrf")
    record["k4_main_path"] = dict(tot, panels=len(heights), rows=per_panel,
                                  fit=fit)
    return tot, len(heights)


def k2_check(torch, pdd, al, bl, base, sa, sb):
    """One fused K2 launch against limb_product_base_reference: (bitwise
    equal, max abs error), failing the run if it took no launch."""
    launches = pdd.LAUNCHES
    got = pdd.limb_product_base(al, bl, base, sa, sb, 7)
    want = pdd.limb_product_base_reference(al, bl, base, sa, sb, 7)
    torch.cuda.synchronize()
    check(pdd.LAUNCHES == launches + 1, "K2 did not launch")
    check(got.dtype == torch.float64 and got.shape == want.shape,
          f"K2 output {got.dtype} {tuple(got.shape)}")
    same = bool(torch.equal(got.view(torch.int64), want.view(torch.int64)))
    return same, float((got - want).abs().max())


def k2_times(torch, dd, pdd, al, bl, base, sa, sb, a64=None, b64=None):
    """Device ms of one fused K2 launch, of ``dd._limb_levels`` alone on
    the same limbs (the unfused route's int8 products and level sums on
    ``torch._int_mm``), of the plain version, and of native FP64
    ``torch.addmm`` on the f64 operands (context: not the same bits;
    None without them)."""
    nl, _, K = al.shape
    planes = list(al), [x.T for x in bl]
    t = {"ms": time_ms(torch, lambda: pdd.limb_product_base(
             al, bl, base, sa, sb, 7)),
         "limb_levels_ms": time_ms(torch, lambda: dd._limb_levels(
             *planes, K, 7, nl, K)),
         "plain_ms": time_ms(torch, lambda: (
             pdd.limb_product_base_reference(al, bl, base, sa, sb, 7))),
         "library_ms": None}
    if a64 is not None:
        c = base if base is not None else torch.zeros(
            (a64.shape[0], b64.shape[1]), dtype=torch.float64,
            device="cuda")
        t["library_ms"] = time_ms(torch, lambda: torch.addmm(
            c, a64, b64, alpha=-1.0))
    return t


def k2_operands(torch, dd, g, nl, M, N, K):
    """Limb planes of random f64 operands A (M, K) and B (K, N), split as
    the dd route splits them, with their scales and the f64 operands."""
    a = torch.randn(M, K, device="cuda", generator=g, dtype=torch.float64)
    b = torch.randn(K, N, device="cuda", generator=g, dtype=torch.float64)
    al, sa, _ = dd._split_rows(a, 7, nl)
    bl, sb, _ = dd._split_rows(b.T, 7, nl)
    return al, bl, sa, sb.T, a, b


def phase_k2(torch, dd, pdd, record):
    g = torch.Generator(device="cuda").manual_seed(500)
    big = torch.randn(N_DD, N_DD, device="cuda", generator=g,
                      dtype=torch.float64)

    def dense(M, N):
        return torch.randn(M, N, device="cuda", generator=g,
                           dtype=torch.float64)

    # (label, nl, M, N, K, base, form): ragged shapes (K = 777 in
    # contiguous planes: TMA needs the aligned copy), the epilogue's three
    # forms, every digit at +-127 at the int32 bound, a split product
    named = [("ragged nl=8, K=777 (aligned copy)", 8, 1000, 300, 777,
              "dense", "copy"),
             ("ragged nl=5, K=777 (aligned copy)", 5, 1000, 300, 777,
              "dense", "copy"),
             ("no base, -sa (gemm_f64 form)", 8, 1000, 300, 1000, None,
              "split"),
             ("unscaled (_pair_dot form)", 8, 640, 384, 512, None,
              "unscaled"),
             ("strided base (a.T view)", 8, 640, 384, 528, "tview",
              "split"),
             ("digits +-127 at K = kc, nl=8", 8, 256, 256,
              pdd.max_depth(8), "dense", "extreme"),
             ("digits +-127 at K = kc, nl=5", 5, 256, 256,
              pdd.max_depth(5), "dense", "extreme"),
             ("split product 512^3", 8, 512, 512, 512, "dense", "split")]
    rows = []
    mabs_all = 0.0
    for label, nl, M, N, K, kind, form in named:
        al, bl, sa, sb, _, _ = k2_operands(torch, dd, g, nl, M, N, K)
        if form == "extreme":
            al.fill_(127)
            bl.fill_(-127)
        if form == "copy":
            al, bl = al.contiguous(), bl.contiguous()
        base = (None if kind is None else dense(M, N) if kind == "dense"
                else big[1000:1000 + N, 512:512 + M].T)
        if form == "unscaled":
            sa = sb = None
        elif base is None:
            sa = -sa
        p = pdd.plan_for(al, bl)
        same, mabs = k2_check(torch, pdd, al, bl, base, sa, sb)
        t = k2_times(torch, dd, pdd, al, bl, base, sa, sb)
        b_ms, b_by = k2_bound_ms(nl, M, N, K, base is not None)
        log(f"[k2] {label:36s} nl={nl} M={M:5d} N={N:5d} K={K:5d} "
            f"splits={p.splits} copy={int(p.a_copy)}{int(p.b_copy)} "
            f"{'bitwise equal' if same else 'DIFFERS'} (max abs err "
            f"{mabs:.3e})  kernel {t['ms']:8.4f} ms  _limb_levels "
            f"{t['limb_levels_ms']:8.4f} ms  plain {t['plain_ms']:8.4f} ms"
            f"  bound {b_ms:8.4f} ms ({b_by})")
        rows.append(dict(t, case=label, nl=nl, M=M, N=N, K=K, base=kind,
                         splits=p.splits, bitwise=same, max_abs_err=mabs,
                         bound_ms=b_ms, bound_by=b_by))
        mabs_all = max(mabs_all, mabs)
        check(same, f"K2 is not bitwise equal to its plain version on "
                    f"{label}: max abs err {mabs:.3e}")
        del al, bl, base
    record["k2_cases"] = rows

    # back-to-back launches of one split shape, each checked
    al, bl, sa, sb, _, _ = k2_operands(torch, dd, g, 8, 512, 512, 512)
    base = dense(512, 512)
    check(pdd.plan_for(al, bl).splits > 1, "the 512^3 product is not split")
    want = pdd.limb_product_base_reference(al, bl, base, sa, sb, 7)
    bad = 0
    for _ in range(K2_REPEATS):
        got = pdd.limb_product_base(al, bl, base, sa, sb, 7)
        bad += int(not torch.equal(got.view(torch.int64),
                                   want.view(torch.int64)))
    torch.cuda.synchronize()
    log(f"[k2] {K2_REPEATS} back-to-back split launches (512^3, "
        f"{pdd.plan_for(al, bl).splits} splits): {bad} differ")
    check(bad == 0, f"{bad} of {K2_REPEATS} split K2 launches differ")
    record["k2_repeats"] = {"launches": K2_REPEATS, "differ": bad}

    # every launch of one dpotrf factorization (N_DD, NB_DD), in turn: the
    # trailing products on views of one limb cache split from random f64
    # (with the factorization's row scales), the residuals on split
    # random operands
    keys = ("ms", "limb_levels_ms", "plain_ms", "library_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    tot.update(max_abs_err=0.0, ops_bound_ms=0.0)
    bound_by = {"operations": 0.0, "bytes": 0.0}
    shapes = dd_k2_shapes(N_DD, NB_DD)
    F = torch.randn(N_DD, N_DD - NB_DD, device="cuda", generator=g,
                    dtype=torch.float64)
    scale = dd._row_norm_scales(torch.full(
        (N_DD,), float(N_DD), device="cuda", dtype=torch.float64))[:, None]
    W = dd._limb_planes(8, N_DD, N_DD - NB_DD, "cuda")
    dd._split_fixed(F * 8.0, scale, 7, 8, out=W)      # |x| < scale / 2
    per = []
    for i, (nl, M, N, K, kind) in enumerate(shapes):
        if kind == "cache":
            s = N_DD - M
            al, bl = W[:, s:, :s], W[:, s:s + N, :s]
            sa, sb = scale[s:], scale[s:s + N].T
            a64, b64 = F[s:, :s] * 8.0, (F[s:s + N, :s] * 8.0).T
            base = big[s:, s:s + N]
        else:
            al, bl, sa, sb, a64, b64 = k2_operands(torch, dd, g, nl, M, N,
                                                   K)
            base = big[NB_DD:, :N] if kind == "view" else dense(M, N)
        p = pdd.plan_for(al, bl)
        check(not (p.a_copy or p.b_copy),
              f"dpotrf launch {i} {(nl, M, N, K, kind)} needs a copy: {p}")
        same, mabs = k2_check(torch, pdd, al, bl, base, sa, sb)
        check(same, f"K2 differs on dpotrf launch {i} "
                    f"{(nl, M, N, K, kind)}: max abs err {mabs:.3e}")
        t = k2_times(torch, dd, pdd, al, bl, base, sa, sb, a64, b64)
        b_ms, b_by = k2_bound_ms(nl, M, N, K, True)
        t_ops = nl * (nl + 1) // 2 * 2.0 * M * N * K / INT8_OPS * 1e3
        for k in keys[:-1]:
            tot[k] += t[k]
        tot["bound_ms"] += b_ms
        tot["ops_bound_ms"] += t_ops
        bound_by[b_by] += b_ms
        tot["max_abs_err"] = max(tot["max_abs_err"], mabs)
        per.append(dict(t, nl=nl, M=M, N=N, K=K, base=kind,
                        splits=p.splits, bound_ms=b_ms, bound_by=b_by))
        del al, bl, a64, b64
    del W, F
    tot["max_abs_err"] = max(tot["max_abs_err"], mabs_all)
    # what bounds the sum: what bounds the launches most of it comes from
    tot["bound_by"] = max(bound_by, key=bound_by.get)
    log(f"[k2] one dpotrf's {len(shapes)} launches (N={N_DD} nb={NB_DD}), "
        f"all bitwise equal: kernel {tot['ms']:.3f} ms  _limb_levels "
        f"{tot['limb_levels_ms']:.3f} ms  plain {tot['plain_ms']:.3f} ms  "
        f"bound {tot['bound_ms']:.3f} ms (int8 operations "
        f"{tot['ops_bound_ms']:.3f} ms)  FP64 addmm "
        f"{tot['library_ms']:.3f} ms")

    # one dgemm dd product at N_DD^3
    al, bl, sa, sb, a64, b64 = k2_operands(torch, dd, g, 8, N_DD, N_DD,
                                           N_DD)
    same, mabs = k2_check(torch, pdd, al, bl, None, -sa, sb)
    check(same, f"K2 differs on the dgemm product: max abs err {mabs:.3e}")
    gemm = k2_times(torch, dd, pdd, al, bl, None, -sa, sb, a64, b64)
    gemm["bound_ms"], gemm["bound_by"] = k2_bound_ms(8, N_DD, N_DD, N_DD,
                                                     False)
    gemm["max_abs_err"] = mabs
    gemm["splits"] = pdd.plan_for(al, bl).splits
    log(f"[k2] one dgemm product {N_DD}^3 (nl=8), bitwise equal: kernel "
        f"{gemm['ms']:.3f} ms  _limb_levels {gemm['limb_levels_ms']:.3f} "
        f"ms  plain {gemm['plain_ms']:.3f} ms  bound {gemm['bound_ms']:.3f}"
        f" ms ({gemm['bound_by']})  FP64 addmm {gemm['library_ms']:.3f} ms")
    del al, bl, a64, b64
    record["k2_main_path"] = dict(tot, launches=len(shapes), dgemm=gemm,
                                  per_launch=per)
    del big
    return tot, len(shapes)


def recorded_k2_products(torch, pdd, run):
    """The K2 launches one call of ``run`` makes, recorded through the
    wrapper: {(nl, M, N, K, base form): row}, each distinct shape with
    its count, its plan (splits, aligned copies) and, from its first
    launch, whether that launch on the path's own operands was bitwise
    equal to limb_product_base_reference (and the max abs error)."""
    seen = {}
    orig = pdd.limb_product_base

    def recorder(al, bl, base, sa, sb, w):
        out = orig(al, bl, base, sa, sb, w)
        nl, M, K = al.shape
        form = ("no base" if base is None else "base" if
                base.is_contiguous() else "strided base")
        key = (nl, M, bl.shape[1], K, form)
        row = seen.get(key)
        if row is None:
            want = pdd.limb_product_base_reference(al, bl, base, sa, sb, w)
            p = pdd.plan_for(al, bl)
            row = seen[key] = {
                "count": 0, "splits": p.splits, "a_copy": p.a_copy,
                "b_copy": p.b_copy,
                "bitwise": bool(torch.equal(out.view(torch.int64),
                                            want.view(torch.int64))),
                "max_abs_err": float((out - want).abs().max())}
        row["count"] += 1
        return out

    pdd.limb_product_base = recorder
    try:
        run()
        torch.cuda.synchronize()
    finally:
        pdd.limb_product_base = orig
    return seen


def k2_path_sum(torch, dd, pdd, g, path, seen, n):
    """Each distinct K2 shape one run of ``path`` recorded (``seen``,
    :func:`recorded_k2_products`), held bitwise on the path's own
    operands, then timed on split random operands of its shape, times
    its count, beside its int8 bound, ``dd._limb_levels`` alone and FP64
    addmm. Returns the sums with the per-shape rows."""
    got = sum(r["count"] for r in seen.values())
    tot = dict.fromkeys(("ms", "limb_levels_ms", "plain_ms",
                         "library_ms", "bound_ms", "ops_bound_ms"), 0.0)
    tot["max_abs_err"] = 0.0
    bound_by = {"operations": 0.0, "bytes": 0.0}
    rows = []
    for (nl, M, N, K, form), row in sorted(seen.items()):
        label = f"{path} nl={nl} M={M} N={N} K={K} {form}"
        check(row["bitwise"], f"K2 differs from its plain version on "
                              f"{label}: max abs err "
                              f"{row['max_abs_err']:.3e}")
        al, bl, sa, sb, a64, b64 = k2_operands(torch, dd, g, nl, M, N,
                                               K)
        base = None if form == "no base" else torch.randn(
            M, N, device="cuda", generator=g, dtype=torch.float64)
        if base is None:
            sa = -sa
        t = k2_times(torch, dd, pdd, al, bl, base, sa, sb, a64, b64)
        b_ms, b_by = k2_bound_ms(nl, M, N, K, base is not None)
        t_ops = nl * (nl + 1) // 2 * 2.0 * M * N * K / INT8_OPS * 1e3
        c = row["count"]
        for k in ("ms", "limb_levels_ms", "plain_ms", "library_ms"):
            tot[k] += c * t[k]
        tot["bound_ms"] += c * b_ms
        tot["ops_bound_ms"] += c * t_ops
        bound_by[b_by] += c * b_ms
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
        log(f"[k2] {label:48s} x{c:3d} splits={row['splits']} copy="
            f"{int(row['a_copy'])}{int(row['b_copy'])} bitwise: kernel "
            f"{t['ms']:8.4f} ms  _limb_levels {t['limb_levels_ms']:8.4f}"
            f" ms  plain {t['plain_ms']:8.4f} ms  addmm "
            f"{t['library_ms']:8.4f} ms  bound {b_ms:8.4f} ms ({b_by})")
        rows.append(dict(row, **t, nl=nl, M=M, N=N, K=K, form=form,
                         bound_ms=b_ms, bound_by=b_by))
        del al, bl, a64, b64, base
    tot["bound_by"] = max(bound_by, key=bound_by.get)
    copies = [r for r in rows if r["a_copy"] or r["b_copy"]]
    log(f"[k2] one {path}'s {got} launches ({len(rows)} shapes, N="
        f"{n}), all bitwise equal: kernel "
        f"{tot['ms']:.3f} ms  _limb_levels {tot['limb_levels_ms']:.3f} "
        f"ms  plain {tot['plain_ms']:.3f} ms  bound {tot['bound_ms']:.3f}"
        f" ms (int8 operations {tot['ops_bound_ms']:.3f} ms)  FP64 addmm "
        f"{tot['library_ms']:.3f} ms; shapes with an aligned copy: "
        f"{len(copies)}")
    return dict(tot, launches=got, shapes=rows)


def phase_k2_lu_qr(torch, dd, pdd, pk, record):
    """K2 on every distinct limb product of one dgetrf dd and one dgeqrf
    dd factorization (N_DDF, NB_DDF): each recorded through the wrapper
    and held bitwise to its plain version on the path's own operands,
    then timed on split random operands of its shape times its count,
    beside its int8 bound, ``dd._limb_levels`` alone and FP64 addmm."""
    from dplasma_tpu_torch.ops import generators, lu, qr
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    g = torch.Generator(device="cuda").manual_seed(700)
    kt, k3t = N_DDF // NB_DDF, N_DDF // NB_DDK3
    A = generators.plrnt(N_DDF, N_DDF, NB_DDF, NB_DDF, seed=3872,
                         dtype=torch.float64)
    A3 = generators.plrnt(N_DDF, N_DDF, NB_DDK3, NB_DDK3, seed=3872,
                          dtype=torch.float64)
    out = {}
    for path, kind, run, want in (
            ("dgetrf_dd", "chain", lambda: lu.getrf_1d(A), dd_lu_k2(kt)),
            (f"dgetrf_dd_nb{NB_DDK3}", "chain", lambda: lu.getrf_1d(A3),
             dd_lu_k2(k3t)),
            ("dgeqrf_dd", "chain", lambda: qr.geqrf(A),
             dd_qr_k2(kt, 4, "chain")),
            ("dgeqrf_dd_tree", "tree", lambda: qr.geqrf(A),
             dd_qr_k2(kt, 4, "tree"))):
        with cfg.override_scope({"dd_gemm": "always",
                                 "panel.kernel": kind}):
            seen = recorded_k2_products(torch, pdd, run)
        got = sum(r["count"] for r in seen.values())
        check(got == want, f"{path}: {got} K2 launches recorded, want "
                           f"{want}")
        out[path] = k2_path_sum(torch, dd, pdd, g, path, seen, N_DDF)
    del A, A3
    record["k2_lu_qr_paths"] = out
    return out


def phase_int_mm_layouts(torch, record):
    """``torch._int_mm`` (the dd route's exact int8 products) in its four
    operand layouts: A row- or column-major times B row- or
    column-major; the dd route hands it A row-major and B column-major
    (both K-contiguous)."""
    g = torch.Generator(device="cuda").manual_seed(600)
    out = {}
    for M, K, N in ((N_DD, N_DD, N_DD), (N_DD - NB_DD, 4096, 4096)):
        a_r = torch.randint(-127, 128, (M, K), device="cuda", generator=g,
                            dtype=torch.int8)
        b_c = torch.randint(-127, 128, (N, K), device="cuda", generator=g,
                            dtype=torch.int8).T
        forms = {"A row, B col": (a_r, b_c),
                 "A row, B row": (a_r, b_c.contiguous()),
                 "A col, B col": (a_r.T.contiguous().T, b_c),
                 "A col, B row": (a_r.T.contiguous().T, b_c.contiguous())}
        want = torch._int_mm(a_r, b_c)
        row = {}
        for name, (a, b) in forms.items():
            check(torch.equal(torch._int_mm(a, b), want),
                  f"_int_mm {name} differs")
            ms = time_ms(torch, lambda: torch._int_mm(a, b))
            row[name] = {"ms": ms, "tops": 2.0 * M * N * K / ms / 1e9}
        log(f"[int8] torch._int_mm M={M} K={K} N={N}: " + ", ".join(
            f"{k} {v['ms']:.3f} ms ({v['tops']:.0f} TOP/s)"
            for k, v in row.items()))
        out[f"{M}x{K}x{N}"] = row
    record["int_mm_layouts"] = out


def phase_spotrf(torch, pk, record):
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.ops import potrf as potrf_mod

    pk.enable(True)
    nt = N_MAIN // NB_MAIN
    want_per_run = 2 * nt - 3
    common.RUNS.clear()
    pk.reset_counts()
    t0 = time.perf_counter()
    rc = main(["testing_spotrf", "-N", str(N_MAIN), "-t", str(NB_MAIN),
               "-x", "-v"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routed = pk.LAUNCHES, pk.ROUTED
    check(rc == 0, f"testing_spotrf exited {rc}")
    check(pk.FFMA_LAUNCHES == 0 and pk.WGMMA_LAUNCHES == launches,
          f"spotrf: {pk.FFMA_LAUNCHES} K1 products took the FFMA kernel")
    run = common.RUNS[-1]
    op = run["ops"][0]
    checks = {c["check"]: c for c in run["checks"]}
    log(f"[spotrf] N={N_MAIN} nb={NB_MAIN} input "
        f"{N_MAIN * N_MAIN * 4 / 2**30:.2f} GiB: best {op['best_s']:.5f} s "
        f"{op['gflops']:.1f} GFLOP/s (warm-up {op['warmup_s']:.3f} s, "
        f"driver wall {wall:.1f} s); K1 launches per factorization "
        f"{op['k1_launches']} (want {want_per_run}), in the whole run "
        f"{launches} (routed {routed}); POTRF residual "
        f"{checks['POTRF']['residual']:.3e}, POTRS residual "
        f"{checks['POTRS |b-Ax|']['residual']:.3e}")
    check(all(n == want_per_run for n in op["k1_launches"]),
          f"K1 launches per factorization {op['k1_launches']} != "
          f"{want_per_run}")
    check(checks["POTRF"]["ok"] and checks["POTRF"]["residual"] < 60,
          "check_potrf failed")
    check(checks["POTRS |b-Ax|"]["ok"], "POTRS check failed")
    record["spotrf"] = {"N": N_MAIN, "nb": NB_MAIN, "best_s": op["best_s"],
                        "gflops": op["gflops"], "warmup_s": op["warmup_s"],
                        "k1_launches_per_factorization": op["k1_launches"],
                        "k1_launches_run": launches, "checks": run["checks"]}

    # a small input on the card against a float64 Cholesky on the host
    A = generators.plghe(2048.0, 2048, 256, seed=7)
    L = potrf_mod.potrf(A, "L").to_dense()
    L64 = torch.linalg.cholesky(A.to_dense().double().cpu())
    err = float((L.double().cpu() - L64).abs().max() / L64.abs().max())
    log(f"[spotrf] N=2048 nb=256 factor vs float64 host Cholesky: "
        f"max rel err {err:.3e} (tol 1e-4)")
    check(bool(torch.isfinite(L).all()) and err <= 1e-4,
          f"small factorization disagrees with float64: {err:.3e}")
    record["spotrf_small_rel_err"] = err

    # one factorization of the main size under torch.profiler
    del A, L
    A = generators.plghe(float(N_MAIN), N_MAIN, NB_MAIN, seed=3872)
    _profile(torch, record, "spotrf_profile", f"N={N_MAIN} nb={NB_MAIN}",
             lambda: potrf_mod.potrf(A, "L"))
    return launches


def phase_sgetrf(torch, pk, plu, record):
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.ops import generators, lu
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    kt = N_LU // NB_LU
    want_k3, want_k1 = kt, 2 * kt - 3
    common.RUNS.clear()
    with cfg.override_scope({"panel.kernel": "pallas"}):
        pk.reset_counts()
        plu.reset_counts()
        t0 = time.perf_counter()
        rc = main(["testing_sgetrf", "-N", str(N_LU), "-t", str(NB_LU),
                   "-x", "-v"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1_run, k3_run = pk.LAUNCHES, plu.LAUNCHES
        k1_ffma = pk.FFMA_LAUNCHES
    check(rc == 0, f"testing_sgetrf exited {rc}")
    check(k1_ffma == 0, f"sgetrf: {k1_ffma} K1 products took the FFMA "
                        f"kernel")
    run = common.RUNS[-1]
    op = run["ops"][0]
    chk = {c["check"]: c for c in run["checks"]}["GETRF |b-Ax|"]
    log(f"[sgetrf] N={N_LU} nb={NB_LU} panel.kernel=pallas K1 on, input "
        f"{N_LU * N_LU * 4 / 2**20:.0f} MiB: best {op['best_s']:.5f} s "
        f"{op['gflops']:.1f} GFLOP/s (warm-up {op['warmup_s']:.3f} s, "
        f"driver wall {wall:.1f} s); per factorization K3 launches "
        f"{op['k3_launches']} (want {want_k3}), K1 launches "
        f"{op['k1_launches']} (want {want_k1}); whole run K3 {k3_run}, K1 "
        f"{k1_run}; GETRF |b-Ax| residual {chk['residual']:.3e}")
    check(all(n == want_k3 for n in op["k3_launches"]),
          f"K3 launches per factorization {op['k3_launches']} != {want_k3}")
    check(all(n == want_k1 for n in op["k1_launches"]),
          f"K1 launches per factorization {op['k1_launches']} != {want_k1}")
    check(chk["ok"], "GETRF |b-Ax| check failed")
    record["sgetrf"] = {"N": N_LU, "nb": NB_LU, "best_s": op["best_s"],
                        "gflops": op["gflops"], "warmup_s": op["warmup_s"],
                        "k3_launches_per_factorization": op["k3_launches"],
                        "k1_launches_per_factorization": op["k1_launches"],
                        "k3_launches_run": k3_run, "k1_launches_run": k1_run,
                        "checks": run["checks"]}

    # a smaller factorization on the card reproduces its input
    A = generators.plrnt(2048, 2048, 256, 256, seed=7)
    with cfg.override_scope({"panel.kernel": "pallas"}):
        LU, perm = lu.getrf_1d(A)
    a, f = A.to_dense().double(), LU.to_dense().double()
    L = torch.tril(f, -1) + torch.eye(2048, device="cuda",
                                      dtype=torch.float64)
    err = float((a[perm] - L @ torch.triu(f)).abs().max() / a.abs().max())
    log(f"[sgetrf] N=2048 nb=256 backward error max|A[perm] - LU|/max|A| "
        f"= {err:.3e} (tol 1e-4)")
    check(bool(torch.isfinite(f).all()) and err <= 1e-4,
          f"small factorization does not reproduce its input: {err:.3e}")
    check(sorted(perm.tolist()) == list(range(2048)), "perm is no "
          "permutation")
    record["sgetrf_small_backward_err"] = err
    return k1_run, k3_run


def _device_ms(ev) -> float:
    us = getattr(ev, "device_time_total", None)
    if us is None:
        us = getattr(ev, "cuda_time_total", 0.0)
    return (us or 0.0) / 1e3


# name pieces of the hand-written kernels, each kept apart in a profile
PORT_KERNELS = ("k1_gemm", "k2_", "k3_lu_panel", "k4_geqrt_panel",
                "k5_ring", "kt_tree", "kw_sweep")

# name pieces of cuBLAS's int8 GEMMs (torch._int_mm): none may run on the
# dd route's main path, whose limb products are K2's
INT8_LIBRARY = ("gemm_s8", "imma")

# kernel-name pieces -> the category the breakdown reports them under
# (first match; a tuple of pieces matches a name that holds them all);
# PyTorch's elementwise kernels are told apart by the functor and the
# element type in their name: the dd route's int64 elementwise work is
# its digit splits and scales (shifts, ands, ors, wheres, clamps,
# negations, scalar arithmetic on the f64 bit patterns)
_CATEGORIES = (("KW (kw_sweep)", ("kw_sweep",)),
               ("KT (kt_tree)", ("kt_tree",)),
               ("K5 (k5_ring)", ("k5_ring",)),
               ("K2 (k2_limb_gemm)", ("k2_",)),
               ("K3 (k3_lu_panel)", ("k3_lu_panel",)),
               ("K4 (k4_geqrt_panel)", ("k4_geqrt_panel",)),
               ("K1 (k1_gemm)", ("k1_gemm",)),
               ("int8 products (torch._int_mm)", INT8_LIBRARY),
               ("cuSOLVER getrf (panel LUs)", ("getrf_pivot", "ipiv_",
                                               "create_pivot")),
               ("cuSOLVER potrf/geqrf/larft", ("potrf", "geqrf", "geqr2",
                                               "larf", "orgqr", "org2r")),
               ("trsm (cuBLAS)", ("trsm",)),
               ("f32 matmuls (cuBLAS SGEMM)",
                ("sgemm", "gemm_f32f32", ("gemm", "<float"),
                 "splitKreduce")),
               ("cuBLAS/cuSOLVER other", ("gemm", "gemv", "geqrf",
                                           "larf", "cublas", "cusolver")),
               ("gathers (index, gather)", ("index", "gather", "Gather")),
               ("cat", ("CatArray",)),
               ("casts and copies", ("copy", "Copy", "transpose")),
               ("digit splits (int64 elementwise: shifts, ands, wheres, "
                "clamps, ...)",
                ("shift_kernel", "bitwise_and", "BitwiseAnd", "where_kernel",
                 "clamp", ("elementwise", "long"))),
               ("adds and subtractions",
                ("CUDAFunctor_add", "CUDAFunctorOnSelf_add", "AddFunctor",
                 "add_kernel")),
               ("muls and divs", ("MulFunctor", "mul_kernel", "DivFunctor",
                                  "div_true", "div_kernel")),
               ("reductions (scales, norms)", ("reduce_kernel",)),
               ("fills", ("FillFunctor", "fill_kernel")),
               ("elementwise other", ("elementwise",)))


def _by_category(by_kernel):
    """{category: ms} of a {kernel name: ms} breakdown (_CATEGORIES)."""
    cats = {}
    for name, ms in by_kernel.items():
        cat = next((c for c, keys in _CATEGORIES
                    if any(all(p in name for p in k) if isinstance(k, tuple)
                           else k in name for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    return cats


def _profile(torch, record, key, label, run):
    """One call of ``run`` (one factorization) under torch.profiler,
    after one warm call: device time by kernel, by category and the
    device's idle share, logged and kept in ``record[key]``."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    # the device's activity only: the host's op events cost the dd
    # routes' many small ops more than the run itself, and slow the call
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel = {}
    for ev in prof.events():
        ms = _device_ms(ev)
        if ms and ev.device_type == cuda:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ms
    busy = sum(by_kernel.values())
    cats = _by_category(by_kernel)
    tag = f"[{key}]"
    if not by_kernel:
        log(f"{tag} the profiler recorded no device time: breakdown not "
            "measured")
        record[key] = {"wall_ms": wall, "busy_ms": None}
        return
    idle = 1.0 - busy / wall
    log(f"{tag} one factorization {label}: wall {wall:.3f} ms, device "
        f"busy {busy:.3f} ms, idle share {100 * idle:.1f}%")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"{tag}   {ms:9.3f} ms {100 * ms / busy:5.1f}%  {cat}")
    log(f"{tag} top device ops:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"{tag}   {ms:9.3f} ms  {name[:96]}")
    record[key] = {
        "wall_ms": wall, "busy_ms": busy, "idle_share": idle,
        "categories_ms": cats,
        "port_kernels_ms": {n: ms for n, ms in by_kernel.items()
                            if any(k in n for k in PORT_KERNELS)},
        "all_kernels_ms": by_kernel,
        "top_kernels_ms": dict(sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1])[:20])}


def phase_sgetrf_profile(torch, pk, record):
    """One factorization of the LU path under torch.profiler."""
    from dplasma_tpu_torch.ops import generators, lu
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    A = generators.plrnt(N_LU, N_LU, NB_LU, NB_LU, seed=3872)
    with cfg.override_scope({"panel.kernel": "pallas"}):
        _profile(torch, record, "sgetrf_profile", f"N={N_LU} nb={NB_LU}",
                 lambda: lu.getrf_1d(A))


def phase_sgeqrf(torch, pk, plu, pqr, record):
    """The QR path through the driver, with every kernel count zeroed
    just before and read just after."""
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.ops import generators, qr
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    kt = N_QR // NB_QR
    want_k4, want_k1 = kt, qr_k1_products(kt)
    common.RUNS.clear()
    with cfg.override_scope({"panel.kernel": "pallas"}):
        pk.reset_counts()
        plu.reset_counts()
        pqr.reset_counts()
        t0 = time.perf_counter()
        rc = main(["testing_sgeqrf", "-N", str(N_QR), "-t", str(NB_QR),
                   "-x", "-v"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1_run, k3_run, k4_run = pk.LAUNCHES, plu.LAUNCHES, pqr.LAUNCHES
        k1_ffma = pk.FFMA_LAUNCHES
    check(rc == 0, f"testing_sgeqrf exited {rc}")
    check(k1_ffma == 0, f"sgeqrf: {k1_ffma} K1 products took the FFMA "
                        f"kernel")
    run = common.RUNS[-1]
    op = run["ops"][0]
    chk = {c["check"]: c["residual"] for c in run["checks"]}
    log(f"[sgeqrf] N={N_QR} nb={NB_QR} panel.kernel=pallas K1 on, input "
        f"{N_QR * N_QR * 4 / 2**20:.0f} MiB: best {op['best_s']:.5f} s "
        f"{op['gflops']:.1f} GFLOP/s (warm-up {op['warmup_s']:.3f} s, "
        f"driver wall {wall:.1f} s); per factorization K4 launches "
        f"{op['k4_launches']} (want {want_k4}), K1 launches "
        f"{op['k1_launches']} (want {want_k1}); whole run K4 {k4_run}, K1 "
        f"{k1_run}, K3 {k3_run}; residuals " + ", ".join(
            f"{name} {res:.3e}" for name, res in chk.items()))
    check(all(n == want_k4 for n in op["k4_launches"]),
          f"K4 launches per factorization {op['k4_launches']} != {want_k4}")
    check(all(n == want_k1 for n in op["k1_launches"]),
          f"K1 launches per factorization {op['k1_launches']} != {want_k1}")
    check(k3_run == 0, f"the QR path launched K3 {k3_run} times")
    check(all(c["ok"] and c["residual"] < 60 for c in run["checks"])
          and len(run["checks"]) == 2, f"sgeqrf -x checks: {run['checks']}")
    record["sgeqrf"] = {"N": N_QR, "nb": NB_QR, "best_s": op["best_s"],
                        "gflops": op["gflops"], "warmup_s": op["warmup_s"],
                        "k4_launches_per_factorization": op["k4_launches"],
                        "k1_launches_per_factorization": op["k1_launches"],
                        "k4_launches_run": k4_run, "k1_launches_run": k1_run,
                        "checks": run["checks"]}

    # a smaller factorization on the card against a float64 QR on the
    # host: |R| (the signs of R's rows may differ) and ||A - QR||
    A = generators.plrnt(2048, 2048, 256, 256, seed=7)
    with cfg.override_scope({"panel.kernel": "pallas"}):
        Af, Tf = qr.geqrf(A)
        Q = qr.ungqr(Af, Tf).to_dense().double().cpu()
    a64 = A.to_dense().double().cpu()
    R = torch.triu(Af.to_dense()).double().cpu()
    R64 = torch.linalg.qr(a64, mode="r")[1]
    r_err = float((R.abs() - R64.abs()).abs().max() / R64.abs().max())
    bwd = float((a64 - Q @ R).abs().max() / a64.abs().max())
    log(f"[sgeqrf] N=2048 nb=256 against a float64 host QR: max||R|-|R64||"
        f"/max|R64| = {r_err:.3e}, max|A - QR|/max|A| = {bwd:.3e} "
        f"(tol 1e-4 each)")
    check(bool(torch.isfinite(R).all()) and r_err <= 1e-4 and bwd <= 1e-4,
          f"small QR disagrees with float64: |R| {r_err:.3e}, A-QR {bwd:.3e}")
    record["sgeqrf_small"] = {"r_abs_rel_err": r_err, "backward_err": bwd}
    return k1_run, k4_run


def phase_sgeqrf_profile(torch, pk, record):
    """One factorization of the QR path under torch.profiler."""
    from dplasma_tpu_torch.ops import generators, qr
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    A = generators.plrnt(N_QR, N_QR, NB_QR, NB_QR, seed=3872)
    with cfg.override_scope({"panel.kernel": "pallas"}):
        _profile(torch, record, "sgeqrf_profile", f"N={N_QR} nb={NB_QR}",
                 lambda: qr.geqrf(A))


def phase_more_drivers(torch, pk, record):
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.utils import config as cfg
    pk.enable(True)
    kt = N_LU // NB_LU
    kq = N_QR // NB_QR
    out = {}
    n_qr = (str(N_QR), "-t")
    # argv, MCA, and whether the K1, K3 and K4 launches of each timed
    # run are right
    for argv, mca, k1_ok, k3_ok, k4_ok in (
            (["testing_sgesv", "-N", str(N_LU), "-t", str(NB_LU), "-x"],
             {"panel.kernel": "pallas"}, lambda n: n >= 2 * kt - 3,
             lambda n: n == kt, lambda n: n == 0),
            (["testing_dgetrf", "-N", str(N_LU), "-t", str(NB_LU), "-x"],
             {}, lambda n: n == 0, lambda n: n == 0, lambda n: n == 0),
            (["testing_dpotrf", "-N", "8192", "-t", "1024", "-x"], {},
             lambda n: n == 0, lambda n: n == 0, lambda n: n == 0),
            (["testing_sgemm", "-N", "8192", "-K", "8192", "-x"], {},
             lambda n: n >= 1, lambda n: n == 0, lambda n: n == 0),
            (["testing_sgels", "-N", *n_qr, str(NB_QR), "-K", "16", "-x"],
             {"panel.kernel": "pallas"}, lambda n: n >= qr_k1_products(kq),
             lambda n: n == 0, lambda n: n == kq),
            (["testing_sgeqrf", "-N", *n_qr, "1024", "-x"], {},
             lambda n: n >= 1, lambda n: n == 0, lambda n: n == 0),
            (["testing_dgeqrf", "-N", *n_qr, str(NB_QR), "-x"], {},
             lambda n: n == 0, lambda n: n == 0, lambda n: n == 0)):
        with cfg.override_scope(mca):
            rc = main(argv)
        torch.cuda.synchronize()
        run = common.RUNS[-1]
        op = run["ops"][0]
        log(f"[{argv[0]}] {' '.join(argv[1:])} {mca or ''}: best "
            f"{op['best_s']:.5f} s {op['gflops']:.1f} GFLOP/s, launches per "
            f"run K1 {op['k1_launches']} K3 {op['k3_launches']} K4 "
            f"{op['k4_launches']}, checks "
            + ", ".join(f"{c['check']}={c['residual']:.3e}"
                        for c in run["checks"]))
        check(rc == 0, f"{argv[0]} exited {rc}")
        check(run["checks"] and all(c["ok"] for c in run["checks"]),
              f"{argv[0]}: checks {run['checks']}")
        for lab, ok in (("k1", k1_ok), ("k3", k3_ok), ("k4", k4_ok)):
            check(all(map(ok, op[f"{lab}_launches"])),
                  f"{argv[0]}: {lab.upper()} launches "
                  f"{op[f'{lab}_launches']}")
        out[argv[0] + " " + " ".join(argv[1:])] = {
            "argv": argv[1:], "mca": mca, "best_s": op["best_s"],
            "gflops": op["gflops"], "k1_launches": op["k1_launches"],
            "k3_launches": op["k3_launches"],
            "k4_launches": op["k4_launches"], "checks": run["checks"]}
    record["drivers"] = out


def phase_dpotrf_dd(torch, pk, pdd, record):
    """The dd Cholesky path: the driver, then one direct call with every
    kernel count zeroed just before and read just after."""
    import numpy as np
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)      # K1 on: the dd route must still launch none
    want_k2 = len(dd_k2_shapes(N_DD, NB_DD))
    dd = {"dd_gemm": "always"}
    common.RUNS.clear()
    with cfg.override_scope(dd):
        t0 = time.perf_counter()
        rc = main(["testing_dpotrf", "-N", str(N_DD), "-t", str(NB_DD),
                   "-x", "-v"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"testing_dpotrf (dd) exited {rc}")
    run = common.RUNS[-1]
    op = run["ops"][0]
    chk = {c["check"]: c["residual"] for c in run["checks"]}
    log(f"[dpotrf-dd] N={N_DD} nb={NB_DD} dd_gemm=always: best "
        f"{op['best_s']:.5f} s {op['gflops']:.1f} GFLOP/s (warm-up "
        f"{op['warmup_s']:.3f} s, driver wall {wall:.1f} s); per "
        f"factorization K2 launches {op['k2_launches']} (want {want_k2}), "
        f"K1 {op['k1_launches']}; residuals " + ", ".join(
            f"{name} {res:.3e}" for name, res in chk.items()))
    check(all(n == want_k2 for n in op["k2_launches"]),
          f"K2 launches per factorization {op['k2_launches']} != {want_k2}")
    check(all(n == 0 for n in op["k1_launches"]), "the dd route ran K1")
    check(len(run["checks"]) == 2 and all(c["ok"] and c["residual"] < 60
                                          for c in run["checks"]),
          f"dpotrf (dd) -x checks: {run['checks']}")

    A = generators.plghe(float(N_DD), N_DD, NB_DD, seed=3872,
                         dtype=torch.float64)
    with cfg.override_scope(dd):
        torch.cuda.synchronize()
        pk.reset_counts()
        pdd.reset_counts()
        L = potrf_mod.potrf(A, "L")
        torch.cuda.synchronize()
        k1, k2, unfused = pk.LAUNCHES, pdd.LAUNCHES, pdd.UNFUSED
    log(f"[dpotrf-dd] one ops.potrf.potrf call, counts zeroed just before: "
        f"K2 {k2} (want {want_k2}), unfused limb products {unfused}, K1 "
        f"{k1}")
    check(k2 == want_k2 and k1 == 0,
          f"dd potrf launched K2 {k2} (want {want_k2}) and K1 {k1} times")
    check(unfused == 0, f"{unfused} dd potrf limb products took the "
                        f"unfused route")
    check(bool(torch.isfinite(L.to_dense()).all()), "dd factor not finite")
    record["dpotrf_dd"] = {
        "N": N_DD, "nb": NB_DD, "best_s": op["best_s"],
        "gflops": op["gflops"], "warmup_s": op["warmup_s"],
        "k2_launches_per_factorization": op["k2_launches"],
        "k2_launches_direct_call": k2, "k1_launches_direct_call": k1,
        "unfused_direct_call": unfused,
        "checks": run["checks"]}
    del L

    # a small factorization on the card against numpy's float64 Cholesky
    A = generators.plghe(1024.0, 1024, 256, seed=7, dtype=torch.float64)
    with cfg.override_scope(dd):
        L = potrf_mod.potrf(A, "L").to_dense().cpu().numpy()
    L64 = np.linalg.cholesky(A.to_dense().cpu().numpy())
    err = float(np.abs(L - L64).max() / np.abs(L64).max())
    log(f"[dpotrf-dd] N=1024 nb=256 factor vs numpy float64 Cholesky: "
        f"max|dL|/max|L| = {err:.3e} (tol {DD_TOL:.0e})")
    check(np.isfinite(L).all() and err <= DD_TOL,
          f"dd factorization disagrees with float64: {err:.3e}")
    record["dpotrf_dd_small_rel_err"] = err
    return k2


def phase_dpotrf_dd_profile(torch, record):
    """One dd factorization under torch.profiler: K2 must be in it and
    no cuBLAS int8 GEMM (the limb products are all K2's)."""
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    from dplasma_tpu_torch.utils import config as cfg
    A = generators.plghe(float(N_DD), N_DD, NB_DD, seed=3872,
                         dtype=torch.float64)
    with cfg.override_scope({"dd_gemm": "always"}):
        _profile(torch, record, "dpotrf_dd_profile",
                 f"N={N_DD} nb={NB_DD} dd", lambda: potrf_mod.potrf(A, "L"))
    prof = record["dpotrf_dd_profile"]
    if prof["busy_ms"] is None:
        return
    names = prof["all_kernels_ms"]
    lib = sorted(n for n in names if any(k in n for k in INT8_LIBRARY))
    check(not lib, f"the dd profile ran cuBLAS int8 GEMMs: {lib[:3]}")
    check(any("k2_" in n for n in names), "the dd profile shows no K2")


def phase_dd_drivers(torch, pk, pdd, record):
    """dgemm on the dd route, and dposv on the dd route and natively."""
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.utils import config as cfg
    pk.enable(True)
    n, t = str(N_DD), str(NB_DD)
    out = {}
    k2_dgemm = 0
    # argv, MCA, and whether the K2 launches of each timed run are right
    for argv, mca, k2_ok in (
            (["testing_dgemm", "-N", n, "-K", n, "-x"],
             {"dd_gemm": "always"}, lambda c: c == 1),
            (["testing_dposv", "-N", n, "-t", t, "-x"],
             {"dd_gemm": "always"},
             lambda c: c >= len(dd_k2_shapes(N_DD, NB_DD))),
            (["testing_dposv", "-N", n, "-t", t, "-x"], {},
             lambda c: c == 0)):
        with cfg.override_scope(mca):
            pdd.reset_counts()
            rc = main(argv + ["-v"])
            torch.cuda.synchronize()
            pdd_launches, unfused = pdd.LAUNCHES, pdd.UNFUSED
        run = common.RUNS[-1]
        op = run["ops"][0]
        launches = op["k2_launches"]
        log(f"[{argv[0]}] {' '.join(argv[1:])} {mca or 'native'}: best "
            f"{op['best_s']:.5f} s {op['gflops']:.1f} GFLOP/s, K2 launches "
            f"per run {launches} (driver run {pdd_launches}), K1 "
            f"{op['k1_launches']}, checks " + ", ".join(
                f"{c['check']}={c['residual']:.3e}" for c in run["checks"]))
        check(rc == 0, f"{argv[0]} exited {rc}")
        check(run["checks"] and all(c["ok"] for c in run["checks"]),
              f"{argv[0]}: checks {run['checks']}")
        check(all(map(k2_ok, launches)), f"{argv[0]}: K2 launches "
                                         f"{launches}")
        check(all(n == 0 for n in op["k1_launches"]),
              f"{argv[0]}: K1 launches {op['k1_launches']}")
        check(unfused == 0, f"{argv[0]}: {unfused} limb products took the "
                            f"unfused route")
        if argv[0] == "testing_dgemm":
            k2_dgemm = pdd_launches
        out[f"{argv[0]} {' '.join(argv[1:])} {mca or 'native'}"] = {
            "argv": argv[1:], "mca": mca, "best_s": op["best_s"],
            "gflops": op["gflops"], "k2_launches": launches,
            "k2_launches_run": pdd_launches, "checks": run["checks"]}
    record["dd_drivers"] = out
    return k2_dgemm


def np_lu_nopiv(a):
    """Unpivoted LU of a float64 numpy matrix, packed L\\U: given the
    dd route's perm, the float64 factor of A[perm]."""
    a = a.copy()
    for k in range(a.shape[0] - 1):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= a[k + 1:, k:k + 1] * a[k:k + 1, k + 1:]
    return a


def dd_driver(torch, pdd, argv, mca, k1_want, k2_want, solve):
    """One driver run (with ``-v``) under ``mca``: its record, checks
    gated when ``-x`` is in argv, and on the dd route every timed run's
    K1 launches equal to ``k1_want`` and its K2 launches equal to
    ``k2_want`` (more when ``solve`` adds a solve), none unfused."""
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.utils import config as cfg
    with cfg.override_scope(mca):
        pdd.reset_counts()
        t0 = time.perf_counter()
        rc = main(argv + ["-v"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        unfused = pdd.UNFUSED
    run = common.RUNS[-1]
    op = run["ops"][0]
    dd = mca.get("dd_gemm") == "always"
    tag = " ".join(f"{k}={v}" for k, v in mca.items()) or "native FP64"
    log(f"[{argv[0]}] {' '.join(argv[1:])} {tag}: best {op['best_s']:.5f} s "
        f"{op['gflops']:.1f} GFLOP/s (warm-up {op['warmup_s']:.3f} s, "
        f"driver wall {wall:.1f} s), per run K2 {op['k2_launches']} K1 "
        f"{op['k1_launches']} K3 {op['k3_launches']}, checks " + ", ".join(
            f"{c['check']}={c['residual']:.3e}" for c in run["checks"]))
    check(rc == 0, f"{argv[0]} ({tag}) exited {rc}")
    if "-x" in argv:
        check(run["checks"] and all(c["ok"] for c in run["checks"]),
              f"{argv[0]} ({tag}): checks {run['checks']}")
    if dd:
        check(all(c > k2_want if solve else c == k2_want
                  for c in op["k2_launches"]),
              f"{argv[0]}: K2 launches {op['k2_launches']} (want "
              f"{'more than ' if solve else ''}{k2_want})")
        check(all(c == k1_want for c in op["k1_launches"]),
              f"{argv[0]}: K1 launches {op['k1_launches']} (want "
              f"{k1_want})")
        check(unfused == 0, f"{argv[0]}: {unfused} limb products took "
                            f"the unfused route")
    else:
        check(not any(op["k2_launches"]) and not any(op["k1_launches"]),
              f"{argv[0]} native ran K1/K2")
    check(not any(op["k3_launches"]), f"{argv[0]}: K3 launches "
                                      f"{op['k3_launches']}")
    return {"argv": argv[1:], "mca": mca, "best_s": op["best_s"],
            "gflops": op["gflops"], "warmup_s": op["warmup_s"],
            "k2_launches": op["k2_launches"],
            "k1_launches": op["k1_launches"], "checks": run["checks"]}


def phase_dd_lu_qr(torch, pk, plu, pdd, record):
    """The dd LU and QR routes: the drivers beside native FP64, direct
    calls with every kernel count zeroed just before and read just
    after, and small factorizations against numpy float64. Returns the
    main path's launches {kernel: {path: n}}.

    The -x checks are gated where the route holds them: LU at nb =
    NB_DDK3, QR at NB_DDF. At the reference ladder's nb = 1024 the LU's
    K = 1024 limb residuals leave the route's accuracy envelope, the
    reference's as the port's (PERF.md, tools/dd_lu_envelope.py): that
    run is timed, its counts gated, and its residual logged."""
    import numpy as np
    from dplasma_tpu_torch.ops import checks, generators, lu, qr
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)      # K1 on: only the QR panels' f32 seeds take it
    dd = {"dd_gemm": "always"}
    chain = dict(dd, **{"panel.kernel": "chain"})
    kt, k3t = N_DDF // NB_DDF, N_DDF // NB_DDK3
    lu_k2 = dd_lu_k2(k3t)
    qr_k1 = kt * nopiv_k1(NB_DDF)
    n, t, t3 = str(N_DDF), str(NB_DDF), str(NB_DDK3)
    drivers = {}
    for argv, mca, k1, k2, solve in (
            (["testing_dgetrf", "-N", n, "-t", t3, "-x"], dd, 0, lu_k2,
             False),
            (["testing_dgesv", "-N", n, "-t", t3, "-x"], dd, 0, lu_k2, True),
            # the default settings: auto takes the tree panels on the card
            (["testing_dgeqrf", "-N", n, "-t", t, "-x"], dd, qr_k1,
             dd_qr_k2(kt, 4, "tree"), False),
            (["testing_dgeqrf", "-N", n, "-t", t, "-x"], chain, qr_k1,
             dd_qr_k2(kt, 4, "chain"), False),
            (["testing_dgels", "-N", n, "-t", t, "-K", "16", "-x"], dd,
             qr_k1, dd_qr_k2(kt, 4, "tree"), True),
            # the ladder's size, outside the LU's envelope: timed only
            (["testing_dgetrf", "-N", n, "-t", t], dd, 0, dd_lu_k2(kt),
             False)):
        for m in (mca, {}):
            key = f"{argv[0]} {' '.join(argv[1:])} {m or 'native'}"
            if key not in drivers:
                drivers[key] = dd_driver(torch, pdd, argv, m, k1, k2, solve)

    def counted(fn):
        torch.cuda.synchronize()
        pk.reset_counts()
        plu.reset_counts()
        pdd.reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, {"s": time.perf_counter() - t0, "k1": pk.LAUNCHES,
                     "k2": pdd.LAUNCHES, "k3": plu.LAUNCHES,
                     "unfused": pdd.UNFUSED}

    # getrf_1d at nb = NB_DDK3: 32 panels, K3 on the f32 seeds;
    # lu.agg_depth 4 must be torch.equal to lu.agg_depth 1
    A = generators.plrnt(N_DDF, N_DDF, NB_DDK3, NB_DDK3, seed=3872,
                         dtype=torch.float64)
    direct = {}
    res = {}
    for agg in (4, 1):
        with cfg.override_scope(dict(dd, **{"panel.kernel": "pallas",
                                             "lu.agg_depth": str(agg)})):
            res[agg], c = counted(lambda: lu.getrf_1d(A))
        want = dd_lu_k2(k3t)
        log(f"[dgetrf-dd] getrf_1d N={N_DDF} nb={NB_DDK3} panel.kernel="
            f"pallas lu.agg_depth={agg}: {c['s']:.3f} s, K3 {c['k3']} (want "
            f"{k3t}), K2 {c['k2']} (want {want}), K1 {c['k1']}, unfused "
            f"{c['unfused']}")
        check(c["k3"] == k3t and c["k2"] == want and c["k1"] == 0,
              f"dd getrf (lu.agg_depth {agg}) launches {c}")
        check(c["unfused"] == 0, f"dd getrf: {c['unfused']} unfused")
        direct[f"getrf_1d nb={NB_DDK3} agg={agg}"] = dict(c, k2_want=want)
    (F4, p4), (F1, p1) = res[4], res[1]
    same = bool(torch.equal(F4.data, F1.data) and torch.equal(p4, p1))
    diff = float((F4.data - F1.data).abs().max())
    log(f"[dgetrf-dd] lu.agg_depth 4 vs 1: torch.equal {same} (max abs "
        f"diff {diff:.3e}, perm equal {bool(torch.equal(p4, p1))})")
    check(same, f"dd getrf lu.agg_depth 4 differs from 1: {diff:.3e}")
    B = generators.plrnt(N_DDF, 1, NB_DDK3, NB_DDK3, seed=3873,
                         dtype=torch.float64)
    with cfg.override_scope(dd):
        r3, ok3 = checks.check_axmb(A, B, lu.getrs("N", F4, p4, B))
    log(f"[dgetrf-dd] nb={NB_DDK3}: |b-Ax| of its solve {r3:.3e}")
    check(ok3, f"dd getrf nb={NB_DDK3} solve check {r3:.3e}")
    del A, B, F4, F1, res

    # the ladder's nb: the LU's solve residual (envelope, logged)
    A = generators.plrnt(N_DDF, N_DDF, NB_DDF, NB_DDF, seed=3872,
                         dtype=torch.float64)
    B = generators.plrnt(N_DDF, 1, NB_DDF, NB_DDF, seed=3873,
                         dtype=torch.float64)
    with cfg.override_scope(dd):
        F, perm = lu.getrf_1d(A)
        r_dd, _ = checks.check_axmb(A, B, lu.getrs("N", F, perm, B))
    r_fs, _ = checks.check_axmb(A, B, lu.getrs("N", F, perm, B))
    F, perm = lu.getrf_1d(A)
    r_nat, _ = checks.check_axmb(A, B, lu.getrs("N", F, perm, B))
    log(f"[dgetrf-dd] nb={NB_DDF} (outside the envelope, not gated): "
        f"|b-Ax| dd factor + dd solve {r_dd:.3e}, dd factor + FP64 solve "
        f"{r_fs:.3e}; native FP64 {r_nat:.3e} (threshold 60)")
    envelope = {"lu_nb1024_dd": r_dd, "lu_nb1024_dd_factor_fp64_solve":
                r_fs, "lu_nb1024_native": r_nat}
    del F, B

    # geqrf at N_DDF, NB_DDF: chain (its square last panel a tree one)
    # and tree panels
    for kind in ("chain", "tree"):
        with cfg.override_scope(dict(dd, **{"panel.kernel": kind})):
            (Af, Tf), c = counted(lambda: qr.geqrf(A))
            Q = qr.ungqr(Af, Tf).to_dense()
            R = torch.triu(Af.to_dense())
            rq, okq = checks.check_qr(A, Q, R)
            ro, oko = checks.check_orthogonality(Q)
        want = dd_qr_k2(kt, 4, kind)
        log(f"[dgeqrf-dd] geqrf N={N_DDF} nb={NB_DDF} {kind} panels: "
            f"{c['s']:.3f} s, K2 {c['k2']} (want {want}), K1 {c['k1']} "
            f"(want {qr_k1}), unfused {c['unfused']}; |A-QR| {rq:.3e}, "
            f"|I-Q'Q| {ro:.3e}")
        check(c["k2"] == want and c["k1"] == qr_k1 and c["k3"] == 0,
              f"dd geqrf ({kind}) launches {c}")
        check(c["unfused"] == 0, f"dd geqrf: {c['unfused']} unfused")
        check(okq and oko, f"dd geqrf ({kind}) checks {rq:.3e} {ro:.3e}")
        direct[f"geqrf nb={NB_DDF} {kind}"] = dict(
            c, k2_want=want, k1_want=qr_k1, qr=rq, orth=ro)
        del Af, Tf, Q, R
    del A

    # small factorizations on the card against numpy float64: LU, QR on
    # the tree panels, and on the chain panels square (its last panel a
    # tree one) and tall (its panels all tall)
    small = {}
    A = generators.plrnt(1024, 1024, 256, 256, seed=7, dtype=torch.float64)
    a = A.to_dense().cpu().numpy()
    with cfg.override_scope(dd):
        F, perm = lu.getrf_1d(A)
    f = F.to_dense().cpu().numpy()
    p = perm.cpu().numpy()
    check(sorted(p.tolist()) == list(range(1024)), "dd perm is no "
          "permutation")
    want = np_lu_nopiv(a[p])
    small["lu_factor"] = float(np.abs(f - want).max() / np.abs(want).max())
    L = np.tril(f, -1) + np.eye(1024)
    small["lu_backward"] = float(np.abs(a[p] - L @ np.triu(f)).max()
                                 / np.abs(a).max())
    for kind, M in (("tree", 1024), ("chain", 1024), ("chain", 2048)):
        A = generators.plrnt(M, 1024, 256, 256, seed=7, dtype=torch.float64)
        a = A.to_dense().cpu().numpy()
        with cfg.override_scope(dict(dd, **{"panel.kernel": kind})):
            Af, Tf = qr.geqrf(A)
            Q = qr.ungqr(Af, Tf).to_dense().cpu().numpy()
        R = np.triu(Af.to_dense().cpu().numpy()[:1024])
        R64 = np.linalg.qr(a, mode="r")
        sgn = np.sign(np.diag(R)) * np.sign(np.diag(R64))
        small[f"qr_{kind}_{M}_r"] = float(
            np.abs(R - sgn[:, None] * R64).max() / np.abs(R64).max())
        small[f"qr_{kind}_{M}_backward"] = float(
            np.abs(a - Q @ R).max() / np.abs(a).max())
        small[f"qr_{kind}_{M}_orth"] = float(
            np.abs(Q.T @ Q - np.eye(1024)).max())
    log("[dd-lu-qr] N=1024 nb=256 against numpy float64 (LU: the factor of "
        "A[perm] and max|A[perm]-LU|/max|A|; QR: R with row signs matched, "
        "max|A-QR|/max|A|, max|Q'Q-I|; chain on M=1024 and 2048): "
        + ", ".join(f"{k} {v:.3e}" for k, v in small.items())
        + f" (tol {DD_TOL:.0e})")
    check(max(small.values()) <= DD_TOL,
          "the dd LU/QR factors disagree with float64")
    record["dd_lu_qr"] = {"drivers": drivers, "direct": direct,
                          "agg_equal": same, "envelope": envelope,
                          "small": small}
    return {
        "k2": {"dgetrf_dd": direct[f"getrf_1d nb={NB_DDK3} agg=4"]["k2"],
               "dgeqrf_dd": sum(direct[f"geqrf nb={NB_DDF} {k}"]["k2"]
                                for k in ("chain", "tree"))},
        "k3": {"dgetrf_dd": direct[f"getrf_1d nb={NB_DDK3} agg=4"]["k3"]},
        "k1": {"dgeqrf_dd": sum(direct[f"geqrf nb={NB_DDF} {k}"]["k1"]
                                for k in ("chain", "tree"))}}


def phase_dd_lu_qr_profile(torch, record):
    """One dd LU (at NB_DDF, cuSOLVER seeds, and at NB_DDK3 with K3
    seeds) and one dd QR factorization (tree panels) under
    torch.profiler, at half phase 11's N (N_DDF_PROF): K2 in each, no
    cuBLAS int8 GEMM. The profiler's post-processing of the dd routes'
    many small kernels took most of the section at N_DDF (phase 18
    profiles its geqrf_cyclic at half size for the same reason)."""
    from dplasma_tpu_torch.ops import generators, lu, qr
    from dplasma_tpu_torch.utils import config as cfg
    for key, nb, kind, fn in (
            ("dgetrf_dd_profile", NB_DDF, "chain", lu.getrf_1d),
            ("dgetrf_dd_k3_profile", NB_DDK3, "pallas", lu.getrf_1d),
            ("dgeqrf_dd_profile", NB_DDF, "tree", qr.geqrf)):
        n = N_DDF_PROF
        A = generators.plrnt(n, n, nb, nb, seed=3872, dtype=torch.float64)
        with cfg.override_scope({"dd_gemm": "always",
                                 "panel.kernel": kind}):
            _profile(torch, record, key, f"N={n} nb={nb} dd {kind}",
                     lambda: fn(A))
        prof = record[key]
        if prof["busy_ms"] is None:
            continue
        names = prof["all_kernels_ms"]
        lib = sorted(n for n in names if any(k in n for k in INT8_LIBRARY))
        check(not lib, f"{key} ran cuBLAS int8 GEMMs: {lib[:3]}")
        check(any("k2_" in n for n in names), f"{key} shows no K2")
        del A


def ir_k2_want(solver, prec, residuals):
    """K2 launches of one IR solve that evaluated ``residuals`` residuals,
    from ops/refine.py: one per residual (gels: the residual and its
    projection Aᵀr), gels' Aᵀb, and the f32x2 rung's whole-matrix
    refinement (posv: E = A − L Lᵀ; gesv: one ``lu_ir`` step; gels: the
    Gram AᵀA and E = G − RᵀR). Escalation adds none under the default
    ``dd_gemm=auto`` (native FP64)."""
    per = 2 if solver == "gels" else 1
    extra = {"posv": 1, "gesv": 1, "gels": 2}[solver] if prec == "f32x2" \
        else 0
    return per * residuals + extra + (1 if solver == "gels" else 0)


def ir_operands(torch, solver, n=None, nb=None):
    """The IR drivers' inputs (their generators and seeds): A and B."""
    from dplasma_tpu_torch.ops import generators
    f64 = torch.float64
    n = n or N_IR
    if solver == "posv":
        nb = nb or NB_IR_POSV
        A = generators.plghe(float(n), n, nb, seed=3872, dtype=f64)
        return A, generators.plrnt(n, NRHS_IR, nb, nb, seed=3873, dtype=f64)
    nb = nb or NB_IR
    m, k = (M_IR_GELS, N_IR_GELS) if solver == "gels" else (n, n)
    A = generators.plrnt(m, k, nb, nb, seed=3872, dtype=f64)
    return A, generators.plrnt(m, NRHS_IR, nb, nb, seed=3873, dtype=f64)


def ir_mca(solver, prec):
    """MCA of an IR run: the rung, and K3/K4 on the LU/QR f32 panels."""
    mca = {"ir.precision": prec}
    if solver != "posv":
        mca["panel.kernel"] = "pallas"
    return mca


def ir_residuals(info):
    """Residuals an IR solve evaluated: its backward-error history less
    the "no verdict" padding."""
    return sum(1 for v in info["backward_errors"].tolist() if v != -1.0)


def phase_k2_ir(torch, dd, pdd, pk, record):
    """K2 on every distinct limb product of the IR solvers at the drivers'
    sizes: one f32x2 solve of each (its shapes include every other
    rung's: the nl = 8 residuals b − A x with nrhs = 4 and K = N, gels'
    projections Aᵀr and Aᵀb with K = M, and the nl = 5 whole-matrix
    products E = A − L Lᵀ, the ``lu_ir`` step and the Gram AᵀA at K =
    8192), recorded through the wrapper and held bitwise to the plain
    version on the path's own operands, then timed times its count."""
    from dplasma_tpu_torch.ops import refine
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    g = torch.Generator(device="cuda").manual_seed(800)
    out = {}
    for solver, fn in (("posv", lambda a, b: refine.posv_ir(a, b, "L")),
                       ("gesv", refine.gesv_ir), ("gels", refine.gels_ir)):
        path = f"{solver}_ir_f32x2"
        A, B = ir_operands(torch, solver)
        res = {}
        with cfg.override_scope(ir_mca(solver, "f32x2")):
            seen = recorded_k2_products(
                torch, pdd, lambda: res.update(info=fn(A, B)[1]))
        info = res["info"]
        want = ir_k2_want(solver, "f32x2", ir_residuals(info))
        got = sum(r["count"] for r in seen.values())
        check(bool(info["converged"]) and not bool(info["escalated"]),
              f"{path} did not converge: {info}")
        check(got == want, f"{path}: {got} K2 launches recorded, want "
                           f"{want}")
        check(not any(r["a_copy"] or r["b_copy"] for r in seen.values()),
              f"{path}: a K2 operand needed an aligned copy")
        out[path] = k2_path_sum(torch, dd, pdd, g, path, seen, N_IR)
        del A, B
    record["k2_ir_paths"] = out
    return out


def ir_driver(torch, pdd, solver, prec, argv, mca):
    """One IR driver run with -x -v under ``mca``: its record, the
    refine summary of its timed run, and the gates of every rung (-x
    passes, no unfused limb product, the timed run's K2 launches equal
    to :func:`ir_k2_want`)."""
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.utils import config as cfg
    with cfg.override_scope(mca):
        pdd.reset_counts()
        counts0 = {lab: mod.LAUNCHES for lab, mod in common.KERNELS}
        t0 = time.perf_counter()
        rc = main(argv + ["-x", "-v"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        unfused = pdd.UNFUSED
    run = common.RUNS[-1]
    op = run["ops"][0]
    s = run["refine"][-1] if run["refine"] else {}
    verdict = ("escalated" if s.get("escalated") else "converged"
               if s.get("converged") else "exhausted")
    tag = " ".join(f"{k}={v}" for k, v in mca.items())
    log(f"[{argv[0]}] {' '.join(argv[1:])} {tag}: best {op['best_s']:.5f} s "
        f"(warm-up {op['warmup_s']:.3f} s, driver wall {wall:.1f} s), "
        f"{verdict} after {s.get('iterations')} corrections, bwd "
        f"{s.get('backward_errors', [None])[-1]}, guard "
        f"{s.get('quant_guard_max')}; per run K1 {op['k1_launches']} K2 "
        f"{op['k2_launches']} K3 {op['k3_launches']} K4 "
        f"{op['k4_launches']}; checks " + ", ".join(
            f"{c['check']}={c['residual']:.3e}" for c in run["checks"]))
    check(rc == 0, f"{argv[0]} ({tag}) exited {rc}")
    check(run["checks"] and all(c["ok"] for c in run["checks"]),
          f"{argv[0]} ({tag}): checks {run['checks']}")
    check(unfused == 0, f"{argv[0]} ({tag}): {unfused} limb products took "
                        f"the unfused route")
    if s.get("converged"):      # every residual it evaluated is finite
        want = ir_k2_want(solver, prec, len(s["backward_errors"]))
        check(op["k2_launches"][-1] == want,
              f"{argv[0]} ({tag}): K2 launches {op['k2_launches']} (want "
              f"{want})")
    return {"argv": argv[1:], "mca": mca, "best_s": op["best_s"],
            "warmup_s": op["warmup_s"], "wall_s": wall, "refine": s,
            "verdict": verdict,
            **{f"{lab}_launches": op[f"{lab}_launches"]
               for lab, _ in common.KERNELS},
            "launches_run": {lab: mod.LAUNCHES - counts0[lab]
                             for lab, mod in common.KERNELS},
            "checks": run["checks"]}


def ir_factor_stages(torch, refine, pk, run):
    """(seconds, K1 launches) of each factor stage of one IR solve
    ``run()``, in call order: the working factorization
    (``refine._factor``), then the f32x2 step (``_factor_refine_chol``,
    ``dd.lu_ir`` or ``_factor_refine_r``), each between two
    synchronizations."""
    stages = []

    def timed(f):
        def call(*a, **kw):
            torch.cuda.synchronize()
            k1, t0 = pk.LAUNCHES, time.perf_counter()
            res = f(*a, **kw)
            torch.cuda.synchronize()
            stages.append((time.perf_counter() - t0, pk.LAUNCHES - k1))
            return res
        return call

    hooks = [(refine, name) for name in ("_factor", "_factor_refine_chol",
                                         "_factor_refine_r")]
    hooks.append((refine._dd, "lu_ir"))
    saved = [getattr(mod, name) for mod, name in hooks]
    try:
        for (mod, name), f in zip(hooks, saved):
            setattr(mod, name, timed(f))
        run()
    finally:
        for (mod, name), f in zip(hooks, saved):
            setattr(mod, name, f)
    return stages


def phase_ir(torch, pk, pdd, record):
    """Phase 12, the mixed-precision IR solvers: the three drivers at
    every rung beside native FP64 at the same size, the ladder's
    configuration as direct calls with the factor's share, and two
    profiles. Returns the drivers' launches {kernel: {path: n}}."""
    from dplasma_tpu_torch.ops import refine
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    n, nrhs = str(N_IR), str(NRHS_IR)
    argvs = {
        "posv": ["testing_dposv_ir", "-N", n, "-t", str(NB_IR_POSV), "-K",
                 nrhs],
        "gesv": ["testing_dgesv_ir", "-N", n, "-t", str(NB_IR), "-K", nrhs],
        "gels": ["testing_dgels_ir", "-M", str(M_IR_GELS), "-N",
                 str(N_IR_GELS), "-t", str(NB_IR), "-K", nrhs]}
    kt = {"gesv": N_IR // NB_IR, "gels": N_IR_GELS // NB_IR}
    drivers = {}
    launches = {lab: {} for lab in ("k1", "k2", "k3", "k4")}
    for solver, argv in argvs.items():
        for prec in IR_RUNGS:
            r = ir_driver(torch, pdd, solver, prec, argv,
                          ir_mca(solver, prec))
            drivers[f"{solver}_ir {prec}"] = r
            s = r["refine"]
            if prec in ("f32", "f32x2") or solver == "posv":
                check(s["converged"] and not s["escalated"],
                      f"{solver}_ir {prec} did not converge: {s}")
            if prec == "int8":
                check(s.get("quant_guard_max", 0.0) > 0,
                      f"{solver}_ir int8: guard {s.get('quant_guard_max')}"
                      f" (0: the int8 route did not run)")
            if solver in kt:
                lab = "k3" if solver == "gesv" else "k4"
                check(all(c == kt[solver] for c in r[f"{lab}_launches"]),
                      f"{solver}_ir {prec}: {lab.upper()} launches "
                      f"{r[f'{lab}_launches']} (want {kt[solver]})")
            for lab in launches:
                launches[lab][f"{solver}_ir"] = launches[lab].get(
                    f"{solver}_ir", 0) + r["launches_run"][lab]
        # native FP64 at the same size, the IR drivers' reference point
        nat = [a for a in argv]
        nat[0] = nat[0].replace("_ir", "")
        drivers[f"{solver} native"] = dd_driver(torch, pdd, nat + ["-x"], {},
                                                0, 0, False)

    # the ladder's configuration as direct calls (and gels_ir at the
    # driver's size): wall (host clock around the synchronized solve,
    # after a warm call), the factor's time and its K1 launches: none
    # under int8, whose routed updates ride qgemm (gels keeps its narrow
    # compact-WY products on K1, fewer than at f32)
    ladder = {}
    lad_kt = N_LAD // NB_LAD
    for solver, rungs, size in (("posv", IR_RUNGS, (N_LAD, NB_LAD)),
                                ("gesv", IR_RUNGS, (N_LAD, NB_LAD)),
                                ("gels", ("int8", "f32"), (None, None))):
        A, B = ir_operands(torch, solver, *size)
        fn = (lambda a, b: refine.posv_ir(a, b, "L")) if solver == "posv" \
            else getattr(refine, f"{solver}_ir")
        for prec in rungs:
            # the ladder's default panels; gels_ir as its driver runs
            mca = ir_mca(solver, prec) if solver == "gels" \
                else {"ir.precision": prec}
            with cfg.override_scope(mca):
                fn(A, B)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                X, info = fn(A, B)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                stages = ir_factor_stages(torch, refine, pk,
                                          lambda: fn(A, B))
            s = refine.summarize(info, op=f"{solver}_ir", precision=prec)
            # the factor: the working factorization and the f32x2 step
            # (an escalated solve's own factorization is not the IR's)
            fac = stages[0][0] + (stages[1][0] if prec == "f32x2" else 0.0)
            key = f"{solver}_ir {prec}" + (" (driver size)"
                                           if solver == "gels" else "")
            ladder[key] = dict(s, wall_s=wall, factor_s=fac,
                               factor_share=fac / wall,
                               factor_k1_launches=stages[0][1])
            verdict = ("escalated" if s["escalated"] else "converged"
                       if s["converged"] else "exhausted")
            log(f"[ir-ladder] {key} {tuple(A.shape)} nb={A.desc.nb} nrhs="
                f"{NRHS_IR}: wall {1e3 * wall:.2f} ms, factor "
                f"{1e3 * fac:.2f} ms ({100 * fac / wall:.1f}%, K1 "
                f"{stages[0][1]}), {verdict} after {s['iterations']} "
                f"corrections, bwd {s['backward_errors'][-1]:.3e}")
            check(X.device.type == "cuda", "the IR solve left the card")
            if solver == "posv" or prec in ("f32", "f32x2"):
                check(s["converged"] and not s["escalated"],
                      f"ladder {solver}_ir {prec}: {s}")
            if solver != "gels" and prec in ("int8", "f32"):
                want = 0 if prec == "int8" else 2 * lad_kt - 3
                check(stages[0][1] == want,
                      f"{key}: the factor launched K1 {stages[0][1]} times "
                      f"(want {want})")
        if solver == "gels":
            k1 = {p: ladder[f"gels_ir {p} (driver size)"][
                "factor_k1_launches"] for p in ("int8", "f32")}
            check(0 < k1["int8"] < k1["f32"], f"gels_ir factor K1 {k1}")
        del A, B

    record["ir"] = {"drivers": drivers, "ladder": ladder}
    return launches


def phase_ir_profile(torch, pk, record):
    """One posv_ir f32x2 and one gesv_ir f32 solve at the drivers' sizes
    under torch.profiler: the factor's kernels, the residuals' digit
    splits and K2, the solves, and the idle share."""
    from dplasma_tpu_torch.ops import refine
    from dplasma_tpu_torch.utils import config as cfg
    pk.enable(True)
    for key, solver, prec, fn in (
            ("posv_ir_f32x2_profile", "posv", "f32x2",
             lambda a, b: refine.posv_ir(a, b, "L")),
            ("gesv_ir_f32_profile", "gesv", "f32", refine.gesv_ir)):
        A, B = ir_operands(torch, solver)
        with cfg.override_scope(ir_mca(solver, prec)):
            _profile(torch, record, key, f"{solver}_ir {prec} N={N_IR}",
                     lambda: fn(A, B))
        prof = record[key]
        if prof["busy_ms"] is not None:
            check(any("k2_" in k for k in prof["all_kernels_ms"]),
                  f"{key} shows no K2")
        del A, B


def ring_counts():
    """(bcast, shift) launches of K5 per factorization on a P×Q grid:
    one broadcast per process row and step (the lookahead carry issues
    the next panel's early, still once per step), and for the LU P−1
    winner-row shifts per process column and step."""
    P, Q = GRID
    kt_gt, kt_pc = N_GT // NB_GT, N_PC // NB_PC
    return {"getrf": (kt_gt * P, kt_gt * Q * (P - 1)),
            "potrf": (kt_pc * P, 0),
            "geqrf": (N_QC_COLS // NB_QC * P, 0)}


def k5_bound_ms(kind, n, nbytes):
    """Least time for one ring transfer of S = ``nbytes`` along n ranks,
    the bytes the function must move over the HBM rate: a broadcast
    reads the root's block once and writes n blocks, (n+1)·S; a shift
    reads and writes every rank's block, 2·n·S."""
    return 1e3 * (n + 1 if kind == "bcast" else 2 * n) * nbytes \
        / HBM_BYTES_S


def k5_case(torch, pring, kind, xs, root=0, chunks=1):
    """One K5 launch against its plain version: (bitwise equal, max abs
    error)."""
    if kind == "bcast":
        got = pring.ring_bcast(xs, root=root, chunks=chunks)
        want = pring.ring_bcast_reference(xs, root, chunks)
    else:
        got = pring.ring_shift(xs)
        want = pring.ring_shift_reference(xs)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    mabs = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))
    return same, mabs


def k5_times(torch, pring, kind, xs, root=0, chunks=1):
    """Device ms of one transfer by K5, by its plain version, by one
    PyTorch call that computes it (``library_ms``: the root's block
    expanded to n and made contiguous; the rotated list stacked), by the
    same moves with ``Tensor.copy_`` into preallocated blocks, and by
    the masked-psum path the factorizations take under
    ``ring.enable=off``."""
    from dplasma_tpu_torch.parallel import cyclic
    n = len(xs)
    outs = [torch.empty_like(xs[0], memory_format=torch.contiguous_format)
            for _ in range(n)]
    if kind == "bcast":
        def copies():
            outs[root].copy_(xs[root])
            for d in range(1, n):
                r = (root + d) % n
                outs[r].copy_(outs[(r - 1) % n])
        k = lambda: pring.ring_bcast(xs, root=root, chunks=chunks)  # noqa
        p = lambda: pring.ring_bcast_reference(xs, root, chunks)  # noqa
        ps = lambda: cyclic._bcast_q(xs, root, False)  # noqa: E731
        lib = lambda: xs[root].unsqueeze(0).expand(  # noqa: E731
            n, -1, -1).contiguous()
    else:
        def copies():
            for r in range(n):
                outs[(r + 1) % n].copy_(xs[r])
        k = lambda: pring.ring_shift(xs)  # noqa: E731
        p = lambda: pring.ring_shift_reference(xs)  # noqa: E731
        ps = lambda: cyclic._psum(xs)  # noqa: E731
        rot = [xs[(r - 1) % n] for r in range(n)]
        lib = lambda: torch.stack(rot)  # noqa: E731
    return {"ms": time_ms(torch, k, reps=20),
            "plain_ms": time_ms(torch, p, reps=20),
            "library_ms": time_ms(torch, lib, reps=20),
            "copy_ms": time_ms(torch, copies, reps=20),
            "psum_ms": time_ms(torch, ps, reps=20),
            "host_us": host_us(torch, k), "library_host_us": host_us(torch, lib),
            "device_us": k5_device_us(torch, k)}


def host_us(torch, fn, reps=200):
    """Wall time of one call on the host (µs), over ``reps`` calls
    enqueued back to back (no synchronisation between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def k5_device_us(torch, fn, reps=20):
    """Device time of one K5 launch (µs): the k5_ring kernels' time in a
    torch.profiler trace of ``reps`` calls, over the launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [ev for ev in prof.events()
           if ev.device_type == cuda and "k5_ring" in ev.name]
    if not evs:
        return None
    return 1e3 * sum(_device_ms(ev) for ev in evs) / len(evs)


def phase_k5(torch, pring, record):
    g = torch.Generator(device="cuda").manual_seed(700)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # every ring size, root and chunk count, f32 and bf16, ragged
    for dt in (f32, bf16):
        for n in (2, 3, 4):
            xs = [torch.randn(1000, 300, device="cuda", generator=g).to(dt)
                  for _ in range(n)]
            for chunks in (1, 4):
                for root in range(n):
                    same, mabs = k5_case(torch, pring, "bcast", xs, root,
                                         chunks)
                    check(same, f"K5 ring_bcast differs from its plain "
                                f"version: n={n} root={root} chunks="
                                f"{chunks} {dt}")
            same, _ = k5_case(torch, pring, "shift", xs)
            check(same, f"K5 ring_shift differs: n={n} {dt}")
            rows.append({"case": f"1000x300 n={n} every root, chunks 1 "
                                 f"and 4, shift", "dtype": str(dt),
                         "bitwise": True})
    log(f"[k5] 1000x300 f32 and bf16, n in (2, 3, 4), every root, chunks "
        f"1 and 4, and the shift: bitwise equal to the plain versions")

    # the main paths' shapes (2x2 grid: n = 2 along each axis), a
    # strided column slice of a slab as the factorizations hand it
    P, Q = GRID
    slab_gt = torch.randn(N_GT // P, N_GT // Q, device="cuda", generator=g)
    slab_pc = torch.randn(N_PC // P, N_PC // Q, device="cuda", generator=g)
    panel_gt = [slab_gt[:, NB_GT:2 * NB_GT]] + [
        torch.empty(N_GT // P, NB_GT, device="cuda") for _ in range(Q - 1)]
    panel_pc = [slab_pc[:, NB_PC:2 * NB_PC]] + [
        torch.empty(N_PC // P, NB_PC, device="cuda") for _ in range(Q - 1)]
    wrows = [torch.randn(NB_GT, N_GT // Q, device="cuda", generator=g)
             for _ in range(P)]
    counts = ring_counts()
    chunks = pring._resolve_chunks(N_GT // P, None)
    shapes = {
        "bcast_getrf": ("bcast", panel_gt, counts["getrf"][0], chunks),
        "shift_getrf": ("shift", wrows, counts["getrf"][1], 1),
        "bcast_potrf": ("bcast", panel_pc, counts["potrf"][0],
                        pring._resolve_chunks(N_PC // P, None)),
    }
    out = {}
    for name, (kind, xs, per_fact, c) in shapes.items():
        same, mabs = k5_case(torch, pring, kind, xs, 0, c)
        r, cols = xs[0].shape
        check(same, f"K5 {name} ({r}x{cols}, n={len(xs)}) differs from "
                    f"its plain version")
        t = k5_times(torch, pring, kind, xs, 0, c)
        nbytes = r * cols * xs[0].element_size()
        b_ms = k5_bound_ms(kind, len(xs), nbytes)
        log(f"[k5] {name:12s} {r}x{cols} f32 n={len(xs)} chunks={c} "
            f"{'strided ' if not xs[0].is_contiguous() else ''}bitwise "
            f"equal: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {t['library_ms']:.4f} ms  copy_ {t['copy_ms']:.4f} ms"
            f"  psum path {t['psum_ms']:.4f} ms  bound {b_ms:.4f} ms "
            f"(host {t['host_us']:.1f} us per launch through the wrapper, "
            f"device {t['device_us'] or float('nan'):.1f} us in the "
            f"profile; library host {t['library_host_us']:.1f} us) "
            f"(bytes, {'(n+1)' if kind == 'bcast' else '2*n'}*S); "
            f"x{per_fact} per factorization")
        out[name] = dict(t, rows=r, cols=cols, n=len(xs), chunks=c,
                         bytes=nbytes, bound_ms=b_ms, bound_by="bytes",
                         max_abs_err=mabs, launches_per_factorization=per_fact)

    # 1000 back-to-back launches of each entry point on one flag buffer
    # (flags are never reset: a stale flag shows from the second launch)
    want = panel_gt[0].contiguous()
    for i in range(1000):
        root = i % Q
        xs = [want if q == root else panel_gt[1] for q in range(Q)]
        got = pring.ring_bcast(xs, root=root, chunks=chunks)
        check(all(torch.equal(o, want) for o in got),
              f"K5 ring_bcast launch {i} of 1000 differs")
    cur = wrows
    for i in range(1000):
        nxt = pring.ring_shift(cur)
        check(all(torch.equal(nxt[(r + 1) % P], cur[r]) for r in range(P)),
              f"K5 ring_shift launch {i} of 1000 differs")
        cur = nxt
    log("[k5] 1000 back-to-back ring_bcast launches (alternating roots) "
        "and 1000 ring_shift launches on one flag buffer each, every one "
        "bitwise right")
    record["k5_cases"] = rows
    record["k5_main_path"] = out
    # per entry point and path: one factorization's launches of its one
    # shape, each timed once, times the count (geqrf_cyclic's panel at
    # N_QC = N_GT, nb 512 is the ptgpanel's broadcast shape)
    tot = {"bcast": {}, "shift": {}}
    for kind, path, name, k in (
            ("bcast", "sgetrf_ptgpanel", "bcast_getrf", counts["getrf"][0]),
            ("shift", "sgetrf_ptgpanel", "shift_getrf", counts["getrf"][1]),
            ("bcast", "potrf_cyclic", "bcast_potrf", counts["potrf"][0]),
            ("bcast", "geqrf_cyclic", "bcast_getrf", counts["geqrf"][0])):
        t = out[name]
        tot[kind][path] = {key: t[key] * k for key in (
            "ms", "plain_ms", "library_ms", "copy_ms", "psum_ms",
            "bound_ms")}
        tot[kind][path].update(max_abs_err=t["max_abs_err"],
                               launches_per_factorization=k,
                               host_us_per_launch=t["host_us"],
                               device_us_per_launch=t["device_us"])
        v = tot[kind][path]
        log(f"[k5] one {path} factorization's {k} {kind}s: kernel "
            f"{v['ms']:.3f} ms  plain {v['plain_ms']:.3f} ms  library "
            f"{v['library_ms']:.3f} ms  copy_ {v['copy_ms']:.3f} ms  psum "
            f"{v['psum_ms']:.3f} ms  bound {v['bound_ms']:.3f} ms")
    record["k5_by_path"] = tot
    return tot


def phase_getrf_ptgpanel(torch, pk, pring, record):
    """The distributed LU through the driver on a 2x2 virtual mesh, with
    every kernel count zeroed just before and read just after."""
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.ops import generators, lu
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    P, Q = GRID
    want_b, want_s = ring_counts()["getrf"]
    common.RUNS.clear()
    pk.reset_counts()
    pring.reset_counts()
    t0 = time.perf_counter()
    rc = main(["testing_sgetrf_ptgpanel", "-N", str(N_GT), "-t", str(NB_GT),
               "-p", str(P), "-q", str(Q), "-x", "-v"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_run, k5_run = pk.LAUNCHES, pring.LAUNCHES
    b_run, s_run = pring.BCAST_LAUNCHES, pring.SHIFT_LAUNCHES
    check(rc == 0, f"testing_sgetrf_ptgpanel exited {rc}")
    check(pk.FFMA_LAUNCHES == 0, f"sgetrf_ptgpanel: {pk.FFMA_LAUNCHES} K1 "
                                 f"products took the FFMA kernel")
    run = common.RUNS[-1]
    op = run["ops"][0]
    chk = {c["check"]: c for c in run["checks"]}["GETRF_PTGPANEL |b-Ax|"]
    log(f"[getrf_ptgpanel] N={N_GT} nb={NB_GT} grid {P}x{Q} K1 on, input "
        f"{N_GT * N_GT * 4 / 2**20:.0f} MiB: best {op['best_s']:.5f} s "
        f"{op['gflops']:.1f} GFLOP/s (warm-up {op['warmup_s']:.3f} s, "
        f"driver wall {wall:.1f} s); per factorization K5 launches "
        f"{op['k5_launches']} (want {want_b + want_s}), K1 "
        f"{op['k1_launches']}; whole run K5 {k5_run} ({b_run} bcast, "
        f"{s_run} shift), K1 {k1_run}; GETRF_PTGPANEL |b-Ax| residual "
        f"{chk['residual']:.3e}")
    check(all(n == want_b + want_s for n in op["k5_launches"]),
          f"K5 launches per factorization {op['k5_launches']} != "
          f"{want_b + want_s}")
    nfact = len(op["k5_launches"]) + int(op["warmup_s"] is not None)
    check((b_run, s_run) == (nfact * want_b, nfact * want_s),
          f"K5 bcast/shift launches {b_run}/{s_run} over {nfact} "
          f"factorizations, want {want_b}/{want_s} each")
    check(chk["ok"], "GETRF_PTGPANEL |b-Ax| check failed")
    want_k1 = sum(c for *_, c in cyclic_k1_products()["sgetrf_ptgpanel"])
    check(all(n == want_k1 for n in op["k1_launches"]),
          f"K1 launches per factorization {op['k1_launches']} != {want_k1}")
    record["getrf_ptgpanel"] = {
        "N": N_GT, "nb": NB_GT, "grid": [P, Q], "best_s": op["best_s"],
        "gflops": op["gflops"], "warmup_s": op["warmup_s"],
        "k5_launches_per_factorization": op["k5_launches"],
        "k1_launches_per_factorization": op["k1_launches"],
        "k5_launches_run": k5_run, "k5_bcast_run": b_run,
        "k5_shift_run": s_run, "k1_launches_run": k1_run,
        "checks": run["checks"]}

    # one direct call on the ring route against ring.enable=off
    A = generators.plrnt(N_GT, N_GT, NB_GT, NB_GT, seed=3872)
    with mesh.use_grid(mesh.make_mesh(P, Q)):
        C = cyclic.CyclicMatrix.from_tile(A, Dist(P=P, Q=Q))
        check(cyclic._cyclic_ring(C.desc, C.dtype, mesh.active(),
                                  need_row=True),
              "ring.enable=auto does not resolve to the ring on this card")
        F1, p1 = cyclic.getrf_cyclic(C)
        with cfg.override_scope({"ring.enable": "off"}):
            before = pring.LAUNCHES
            F0, p0 = cyclic.getrf_cyclic(C)
            check(pring.LAUNCHES == before, "ring.enable=off launched K5")
        torch.cuda.synchronize()
        same = torch.equal(p0, p1) and all(
            torch.equal(a, b) for r0, r1 in zip(F0.data, F1.data)
            for a, b in zip(r0, r1))
        log(f"[getrf_ptgpanel] direct getrf_cyclic: ring route "
            f"{'torch.equal' if same else 'DIFFERS FROM'} the psum route "
            f"(factor and perm)")
        check(same, "getrf_cyclic: the ring route differs from the psum "
                    "route")
        del F0, F1, C
        _profile(torch, record, "getrf_ptgpanel_profile",
                 f"N={N_GT} nb={NB_GT} grid {P}x{Q}",
                 lambda: lu.getrf_ptgpanel(A))
    return k5_run, b_run, s_run, k1_run


def phase_potrf_cyclic(torch, pk, pring, record):
    """The distributed Cholesky by a direct call, with every kernel count
    zeroed just before and read just after one timed factorization."""
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.ops import checks, generators
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    P, Q = GRID
    want_b, _ = ring_counts()["potrf"]
    A = generators.plghe(float(N_PC), N_PC, NB_PC, seed=3872)
    with mesh.use_grid(mesh.make_mesh(P, Q)):
        C = cyclic.CyclicMatrix.from_tile(A, Dist(P=P, Q=Q))
        cyclic.potrf_cyclic(C)            # warm-up
        torch.cuda.synchronize()
        pk.reset_counts()
        pring.reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        L = cyclic.potrf_cyclic(C)
        end.record()
        torch.cuda.synchronize()
        secs = start.elapsed_time(end) / 1e3
        k5, b, s, k1 = (pring.LAUNCHES, pring.BCAST_LAUNCHES,
                        pring.SHIFT_LAUNCHES, pk.LAUNCHES)
        check(pk.FFMA_LAUNCHES == 0, f"potrf_cyclic: {pk.FFMA_LAUNCHES} K1 "
                                     f"products took the FFMA kernel")
        res, ok = checks.check_potrf(A, L.to_tile(), "L")
        with cfg.override_scope({"ring.enable": "off"}):
            L0 = cyclic.potrf_cyclic(C)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for r0, r1 in zip(L0.data, L.data)
                   for a, b_ in zip(r0, r1))
        del L0
        _profile(torch, record, "potrf_cyclic_profile",
                 f"N={N_PC} nb={NB_PC} grid {P}x{Q}",
                 lambda: cyclic.potrf_cyclic(C))
    from dplasma_tpu_torch.utils import flops
    gflops = flops.potrf(N_PC, False) / 1e9 / secs
    spotrf = record.get("spotrf", {}).get("best_s")
    log(f"[potrf_cyclic] N={N_PC} nb={NB_PC} grid {P}x{Q} K1 on: "
        f"{secs:.5f} s {gflops:.1f} GFLOP/s (LAWN-41; one card, spotrf "
        f"on the same card {spotrf if spotrf is None else f'{spotrf:.5f}'}"
        f" s); K5 launches {k5} ({b} bcast, want {want_b}; {s} shift), K1 "
        f"{k1}; POTRF residual {float(res):.3e}; ring route "
        f"{'torch.equal' if same else 'DIFFERS FROM'} the psum route")
    check(b == want_b and s == 0 and k5 == want_b,
          f"potrf_cyclic launched K5 {b} bcast / {s} shift, want {want_b}")
    want_k1 = sum(c for *_, c in cyclic_k1_products()["potrf_cyclic"])
    check(k1 == want_k1, f"potrf_cyclic launched K1 {k1} times, want "
                         f"{want_k1}")
    check(bool(ok) and float(res) < 60, f"check_potrf failed: {float(res)}")
    check(same, "potrf_cyclic: the ring route differs from the psum route")
    record["potrf_cyclic"] = {
        "N": N_PC, "nb": NB_PC, "grid": [P, Q], "s": secs, "gflops": gflops,
        "spotrf_best_s": spotrf, "k5_launches": k5, "k1_launches": k1,
        "potrf_residual": float(res), "ring_equals_psum": same}
    return b, k1


# phase 13: the Cholesky inverse family at the spotrf ladder's size, the
# Level-3 BLAS and norm drivers at 8192, the dd inverses at the
# dpotrf_f64equiv size
N_INV, NB_INV = N_MAIN, NB_MAIN
N_B3, NB_B3 = 8192, 512
N_LANM2 = 8192


def inv_k1(kt):
    """K1 products per call of each inverse-family op at KT diagonal
    tiles (ops/potrf.py): trtri's recursion 2·(KT − 1), lauum 1, potri
    both, poinv potrf's 2·KT − 3 more."""
    trtri = 2 * (kt - 1)
    return {"trtri": trtri, "lauum": 1, "potri": trtri + 1,
            "poinv": 2 * kt - 3 + trtri + 1}


def inv_k2(kt):
    """K2 launches per call under dd_gemm=always: trtri's 2·(KT − 1)
    products and two Newton steps of two products on each of its KT
    leaves (dd.trtri_f64), lauum 1, poinv potrf's 5·KT − 3 more."""
    trtri = 2 * (kt - 1) + 4 * kt
    return {"trtri": trtri, "potri": trtri + 1,
            "poinv": 5 * kt - 3 + trtri + 1}


def blas3_driver(torch, pk, pdd, argv, mca, k1_want, k2_want,
                 gate_x=True):
    """One driver run (with ``-v``), every kernel count zeroed just
    before and read just after: rc 0, every -x check passing, each timed
    run's K1 and K2 launches equal to the wants, no K1 product on the
    FFMA kernel, no limb product unfused. With ``gate_x`` False a failed
    -x check (rc 1) is logged, not gated: a route outside its accuracy
    envelope in the reference too. Returns its record."""
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.utils import config as cfg
    with cfg.override_scope(mca):
        pk.reset_counts()
        pdd.reset_counts()
        t0 = time.perf_counter()
        rc = main(argv + ["-v"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1_run, k2_run = pk.LAUNCHES, pdd.LAUNCHES
        ffma, unfused = pk.FFMA_LAUNCHES, pdd.UNFUSED
    run = common.RUNS[-1]
    tag = " ".join(f"{k}={v}" for k, v in mca.items()) or (
        "native FP64" if argv[0][8] == "d" else "K1 on")
    for op in run["ops"]:
        warm = ("none" if op["warmup_s"] is None
                else f"{op['warmup_s']:.3f} s")
        log(f"[{argv[0]}] {' '.join(argv[1:])} {tag}: {op['op']} best "
            f"{op['best_s']:.5f} s {op['gflops']:.1f} GFLOP/s (warm-up "
            f"{warm}), per run K1 {op['k1_launches']} K2 "
            f"{op['k2_launches']}")
    log(f"[{argv[0]}] driver wall {wall:.1f} s, launches in the run K1 "
        f"{k1_run} K2 {k2_run}, checks " + (", ".join(
            f"{c['check']}={c['residual']:.3e}" for c in run["checks"])
            or "none"))
    if gate_x:
        check(rc == 0, f"{argv[0]} ({tag}) exited {rc}")
        if "-x" in argv:
            check(run["checks"] and all(c["ok"] for c in run["checks"]),
                  f"{argv[0]} ({tag}): checks {run['checks']}")
    else:
        check(rc in (0, 1) and run["checks"],
              f"{argv[0]} ({tag}) exited {rc}")
        log(f"[{argv[0]}] ({tag}) -x logged, not gated: " + ", ".join(
            f"{c['check']} {'passes' if c['ok'] else 'fails'} at "
            f"{c['residual']:.3e}" for c in run["checks"]))
    for op in run["ops"]:
        check(all(n == k1_want for n in op["k1_launches"]),
              f"{argv[0]} ({tag}): K1 launches {op['k1_launches']} (want "
              f"{k1_want})")
        check(all(n == k2_want for n in op["k2_launches"]),
              f"{argv[0]} ({tag}): K2 launches {op['k2_launches']} (want "
              f"{k2_want})")
    check(ffma == 0, f"{argv[0]}: {ffma} K1 products took the FFMA kernel")
    check(unfused == 0, f"{argv[0]}: {unfused} limb products unfused")
    return {"argv": argv[1:], "mca": mca,
            "ops": {op["op"]: {"best_s": op["best_s"],
                               "gflops": op["gflops"],
                               "warmup_s": op["warmup_s"],
                               "k1_launches": op["k1_launches"],
                               "k2_launches": op["k2_launches"]}
                    for op in run["ops"]},
            "best_s": run["ops"][0]["best_s"],
            "gflops": run["ops"][0]["gflops"],
            "k1_launches_run": k1_run, "k2_launches_run": k2_run,
            "checks": run["checks"], "x_gated": gate_x, "wall_s": wall}


def library_calls(torch):
    """{driver: (label, fn)}: one PyTorch call computing the same
    function on the same kind of input, where there is one (context for
    the drivers' times, never called by the port)."""
    from dplasma_tpu_torch.ops import generators

    n, m = N_INV, N_B3
    A = generators.plghe(float(n), n, NB_INV, seed=3872).to_dense()
    L = torch.linalg.cholesky(A)
    Lt = torch.tril(A)
    eye = torch.eye(n, device="cuda")
    B = generators.plrnt(m, m, NB_B3, NB_B3, seed=3873).to_dense()
    # testing_slanm2's own matrix
    Bl = generators.plrnt(N_LANM2, N_LANM2, NB_B3, NB_B3,
                          seed=3872).to_dense()
    C = generators.plrnt(m, m, NB_B3, NB_B3, seed=3874).to_dense()
    S = generators.plghe(float(m), m, NB_B3, seed=3872).to_dense()
    St = torch.tril(S)
    A64 = generators.plghe(float(N_DD), N_DD, NB_DD, seed=3872,
                           dtype=torch.float64).to_dense()
    L64 = torch.linalg.cholesky(A64)
    return {
        "testing_spotri": ("torch.cholesky_inverse",
                           lambda: torch.cholesky_inverse(L)),
        "testing_spoinv": ("torch.linalg.inv", lambda: torch.linalg.inv(A)),
        "testing_strtri": ("torch.linalg.solve_triangular against I",
                           lambda: torch.linalg.solve_triangular(
                               Lt, eye, upper=False)),
        "testing_slauum": ("torch.matmul(L.T, L)",
                           lambda: torch.matmul(Lt.T, Lt)),
        "testing_ssymm": ("torch.addmm", lambda: torch.addmm(
            C, S, B, beta=0.3, alpha=0.7)),
        "testing_shemm": ("torch.addmm", lambda: torch.addmm(
            C, S, B, beta=0.3, alpha=0.7)),
        "testing_ssyrk": ("torch.matmul(a, a.T)",
                          lambda: torch.matmul(B, B.T)),
        "testing_sherk": ("torch.matmul(a, a.T)",
                          lambda: torch.matmul(B, B.T)),
        "testing_strmm": ("torch.matmul(tril(A), B)",
                          lambda: torch.matmul(St, B)),
        "testing_strsm": ("torch.linalg.solve_triangular",
                          lambda: torch.linalg.solve_triangular(
                              St, B, upper=False)),
        "testing_slange": ("torch.linalg.matrix_norm(fro)",
                           lambda: torch.linalg.matrix_norm(B, "fro")),
        "testing_slanhe": ("torch.linalg.matrix_norm(fro)",
                           lambda: torch.linalg.matrix_norm(S, "fro")),
        "testing_slansy": ("torch.linalg.matrix_norm(fro)",
                           lambda: torch.linalg.matrix_norm(S, "fro")),
        "testing_slantr": ("torch.linalg.matrix_norm(fro)",
                           lambda: torch.linalg.matrix_norm(St, "fro")),
        "testing_slanm2": ("torch.linalg.matrix_norm(2)",
                           lambda: torch.linalg.matrix_norm(Bl, 2)),
        "testing_dpotri": ("torch.cholesky_inverse (FP64)",
                           lambda: torch.cholesky_inverse(L64)),
        "testing_dpoinv": ("torch.linalg.inv (FP64)",
                           lambda: torch.linalg.inv(A64))}


def phase_blas3_inverse(torch, pk, pdd, dd, record):
    """Phase 13: the Cholesky inverse family and the Level-3 BLAS and
    norm drivers through ``drivers.main`` with K1 on, the dd inverses
    beside native FP64, one library call beside each driver where there
    is one, every distinct K1 product of the new ops and every distinct
    K2 product of one dd poinv recorded through the wrappers and held to
    their plain versions, and two profiles. Returns ({path: K1 sums},
    {path: K2 sums}, K1 driver launches by path, K2 by path)."""
    from dplasma_tpu_torch.drivers import main as driver_main
    from dplasma_tpu_torch.ops import blas3, generators, norms
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    kt, kb, kd = N_INV // NB_INV, N_B3 // NB_B3, N_DD // NB_DD
    k1n, k2n = inv_k1(kt), inv_k2(kd)
    n, t = str(N_INV), str(NB_INV)
    m, tb = str(N_B3), str(NB_B3)
    nd, td = str(N_DD), str(NB_DD)
    dd_on = {"dd_gemm": "always"}
    runs = [
        (["testing_spotri", "-N", n, "-t", t, "-x"], {}, k1n["potri"], 0),
        (["testing_spoinv", "-N", n, "-t", t, "-x"], {}, k1n["poinv"], 0),
        (["testing_strtri", "-N", n, "-t", t], {}, k1n["trtri"], 0),
        (["testing_slauum", "-N", n, "-t", t], {}, k1n["lauum"], 0),
        (["testing_ssymm", "-M", m, "-N", m, "-t", tb], {}, 1, 0),
        (["testing_shemm", "-M", m, "-N", m, "-t", tb], {}, 1, 0),
        (["testing_ssyrk", "-N", m, "-K", m, "-t", tb], {}, 1, 0),
        (["testing_sherk", "-N", m, "-K", m, "-t", tb], {}, 1, 0),
        (["testing_ssyr2k", "-N", m, "-K", m, "-t", tb], {}, 2, 0),
        (["testing_sher2k", "-N", m, "-K", m, "-t", tb], {}, 2, 0),
        (["testing_strmm", "-M", m, "-N", m, "-t", tb], {}, 1, 0),
        (["testing_strsm", "-M", m, "-N", m, "-t", tb, "-x"], {}, kb - 1,
         0),
        (["testing_slange", "-M", m, "-N", m, "-t", tb], {}, 0, 0),
        (["testing_slanhe", "-N", m, "-t", tb], {}, 0, 0),
        (["testing_slansy", "-N", m, "-t", tb], {}, 0, 0),
        (["testing_slantr", "-M", m, "-N", m, "-t", tb], {}, 0, 0),
        (["testing_slanm2", "-M", str(N_LANM2), "-N", str(N_LANM2), "-t",
          tb], {}, 0, 0),
        (["testing_sgeadd", "-M", m, "-N", m, "-t", tb], {}, 0, 0),
        (["testing_stradd", "-M", m, "-N", m, "-t", tb], {}, 0, 0),
        (["testing_dpotri", "-N", nd, "-t", td, "-x"], dd_on, 0,
         k2n["potri"]),
        (["testing_dpotri", "-N", nd, "-t", td, "-x"], {}, 0, 0),
        (["testing_dpoinv", "-N", nd, "-t", td, "-x"], dd_on, 0,
         k2n["poinv"]),
        (["testing_dpoinv", "-N", nd, "-t", td, "-x"], {}, 0, 0)]
    drivers = {}
    k1_by, k2_by = {}, {}
    for argv, mca, k1w, k2w in runs:
        r = blas3_driver(torch, pk, pdd, argv, mca, k1w, k2w)
        key = f"{argv[0]} {' '.join(argv[1:])}" + (" dd" if mca else "")
        drivers[key] = r
        path = argv[0][8:] + ("_dd" if mca else "")
        if r["k1_launches_run"]:
            k1_by[path] = r["k1_launches_run"]
        if r["k2_launches_run"]:
            k2_by[path] = r["k2_launches_run"]
    # the print driver times nothing: it prints the descriptor
    rc = driver_main(["testing_sprint", "-M", m, "-N", m, "-t", tb])
    check(rc == 0, f"testing_sprint exited {rc}")
    for a, b in (("testing_dpotri", "potri"), ("testing_dpoinv", "poinv")):
        dd_s = drivers[f"{a} -N {nd} -t {td} -x dd"]["best_s"]
        fp64 = drivers[f"{a} -N {nd} -t {td} -x"]["best_s"]
        log(f"[{a}] N={N_DD} nb={NB_DD}: dd {dd_s:.5f} s, native FP64 "
            f"{fp64:.5f} s, dd / FP64 {dd_s / fp64:.1f}x")

    # one library call beside each driver that has one
    lib = {}
    for prog, (label, fn) in library_calls(torch).items():
        if prog == "testing_slanm2":
            # the 2-norm is a full SVD (seconds): one timed call, its
            # value lanm2's -x yardstick below
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sigma = float(fn())
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = time_ms(torch, fn)
        ops = next(r["ops"] for k, r in drivers.items()
                   if k.startswith(prog + " ") and not k.endswith(" dd"))
        best = ops.get(prog + ":F", next(iter(ops.values())))["best_s"]
        log(f"[library] {prog}: {label} {ms:.3f} ms (the driver's best "
            f"{1e3 * best:.3f} ms)")
        lib[prog] = {"call": label, "ms": ms, "driver_ms": 1e3 * best}
    torch.cuda.empty_cache()

    # lanm2's -x check (|estimate − σ1| / σ1 < 1e-2 against the SVD) on
    # the driver's matrix, logged: the reference's fixed 20 power
    # iterations do not reach it at this size (ROADMAP queue 3)
    est = float(norms.lanm2(generators.plrnt(N_LANM2, N_LANM2, NB_B3, NB_B3,
                                             seed=3872)))
    lanm2_r = abs(est - sigma) / sigma
    log(f"[testing_slanm2] N={N_LANM2}: 20 power iterations {est:.6f}, "
        f"SVD 2-norm {sigma:.6f}, |Δ|/σ1 {lanm2_r:.3e} (the -x gate 1e-2 "
        f"is not gated here: the reference's algorithm misses it too)")

    # every distinct K1 product of the new ops, recorded through the
    # wrapper on one direct call each, held and timed as phase 2 does
    A = generators.plghe(float(N_INV), N_INV, NB_INV, seed=3872)
    Ab = generators.plrnt(N_B3, N_B3, NB_B3, NB_B3, seed=3873)
    Bb = generators.plrnt(N_B3, N_B3, NB_B3, NB_B3, seed=3874)
    Cb = generators.plghe(float(N_B3), N_B3, NB_B3, seed=3875)
    calls = {
        "strtri": (lambda: potrf_mod.trtri(A, "L"), k1n["trtri"]),
        "slauum": (lambda: potrf_mod.lauum(A, "L"), 1),
        "ssymm": (lambda: blas3.symm(0.7, Cb, Ab, 0.3, Bb), 1),
        "ssyrk": (lambda: blas3.syrk(0.7, Ab, 0.3, Cb), 1),
        "ssyr2k": (lambda: blas3.syr2k(0.7, Ab, Bb, 0.3, Cb), 2),
        "strmm": (lambda: blas3.trmm(1.0, Cb, Ab), 1),
        "strsm": (lambda: blas3.trsm(1.0, Cb, Ab), kb - 1)}
    k1_paths = {}
    for j, (path, (run, want)) in enumerate(calls.items()):
        prods = recorded_k1_products(torch, pk, run)
        got = sum(p[-1] for p in prods)
        check(got == want, f"{path}: {got} K1 products recorded, want "
                           f"{want}")
        k1_paths[path] = k1_path_sum(torch, pk, record, path, prods,
                                     1300 + 20 * j)
    del A, Ab, Bb, Cb
    spotrf = record["k1_main_path"]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ffma_ms",
            "products")
    k1_paths["spotri"] = {k: k1_paths["strtri"][k] + k1_paths["slauum"][k]
                          for k in keys}
    k1_paths["spotri"]["max_abs_err"] = max(
        k1_paths["strtri"]["max_abs_err"], k1_paths["slauum"]["max_abs_err"])
    k1_paths["spoinv"] = dict(
        {k: k1_paths["spotri"][k] + spotrf[k] for k in keys},
        max_abs_err=max(k1_paths["spotri"]["max_abs_err"],
                        spotrf["max_abs_err"]))
    for path in ("spotri", "spoinv"):
        t_ = k1_paths[path]
        log(f"[k1] one {path}'s {t_['products']} products: kernel "
            f"{t_['ms']:.3f} ms  plain {t_['plain_ms']:.3f} ms  torch "
            f"{t_['library_ms']:.3f} ms  bound {t_['bound_ms']:.3f} ms "
            f"(3xTF32)")

    # every distinct K2 product of one dd poinv, held bitwise on the
    # path's own operands, then timed times its count
    A64 = generators.plghe(float(N_DD), N_DD, NB_DD, seed=3872,
                           dtype=torch.float64)
    pdd.reset_counts()
    with cfg.override_scope(dd_on):
        seen = recorded_k2_products(torch, pdd,
                                    lambda: potrf_mod.poinv(A64, "L"))
    got = sum(r["count"] for r in seen.values())
    check(got == k2n["poinv"] and pdd.UNFUSED == 0,
          f"dpoinv dd: {got} K2 launches recorded (want {k2n['poinv']}), "
          f"{pdd.UNFUSED} unfused")
    g = torch.Generator(device="cuda").manual_seed(1400)
    k2_paths = {"dpoinv_dd": k2_path_sum(torch, dd, pdd, g, "dpoinv_dd",
                                         seen, N_DD)}

    # where the time goes: one spoinv and one dd poinv
    A = generators.plghe(float(N_INV), N_INV, NB_INV, seed=3872)
    _profile(torch, record, "spoinv_profile", f"N={N_INV} nb={NB_INV}",
             lambda: potrf_mod.poinv(A, "L"))
    del A
    with cfg.override_scope(dd_on):
        _profile(torch, record, "dpoinv_dd_profile",
                 f"N={N_DD} nb={NB_DD}", lambda: potrf_mod.poinv(A64, "L"))
    record["blas3_inverse"] = {"drivers": drivers, "library": lib,
                               "lanm2_vs_svd": {"N": N_LANM2, "est": est,
                                                "svd": sigma,
                                                "residual": lanm2_r},
                               "k1_paths": k1_paths,
                               "k2_paths": k2_paths}
    return k1_paths, k2_paths, k1_by, k2_by


# phase 14: the complex dtypes at the spotrf ladder's width and the
# Level-3 BLAS size, z on the dd route, and the rest of the pivoted-LU
# family
N_CX, NB_CX, NB_CX_LU = 8192, 512, 256
N_ZDD, NB_ZDD = N_DD, NB_DD      # zpotrf dd: dpotrf_f64equiv's size
N_ZDD_LU = 4096                  # zgetrf / zgeqrf dd, cut for time
N_LUF, NB_LUF = 8192, 512        # sgetrf_incpiv, sgetrf_qrf, sgesv_incpiv
N_LUF_DD = 4096                  # dgetrf_incpiv dd


def zpotrf_dd_k2(kt):
    """K2 launches of one zpotrf under dd_gemm=always (the tile sweep:
    the blocked route is real-only): per tile potrf_f64's 16 complex
    products (4 Newton, 3 refinements of 4), per panel trsm_f64's 5
    (4 Newton, 1 apply), 2·kt − 3 update products; two limb products
    each."""
    return 2 * (16 * kt + 5 * (kt - 1) + 2 * kt - 3)


def zgetrf_dd_k2(kt):
    """K2 launches of one zgetrf under dd (the plain pivoted sweep):
    2·kt − 3 block applies of one complex trsm_f64 (5 products) and one
    update product, two limb products each."""
    return 12 * (2 * kt - 3)


def zgeqrf_dd_k2(kt):
    """K2 launches of one zgeqrf under dd (vendor panels, qr.agg_depth
    4): kt larft Grams, 3 products per apply (kt − 1 lookahead applies
    and the far block's agg_applies), two limb products each."""
    return 2 * (kt + 3 * (kt - 1 + agg_applies(kt, 4)))


def incpiv_k1(kt):
    """K1 products of one getrf_incpiv: one per couple with a trailing
    block."""
    return kt * (kt - 1) // 2


def gesv_incpiv_k1(kt):
    """getrf_incpiv's, getrs_incpiv's couple applies and its upper
    solve's kt − 1 (``blas3.trsm``)."""
    return 2 * incpiv_k1(kt) + kt - 1


def qrf_all_qr_k1(kt):
    """K1 products of one getrf_qrf whose panels are all QR: a larft
    Gram per panel, 3 per apply on a trailing block."""
    return kt + 3 * (kt - 1)


def dincpiv_dd_k2(kt):
    """K2 launches of one dgetrf_incpiv under dd: a real trsm_f64 is 2
    limb residuals, one per diagonal tile with a trailing block; per
    couple with one, a trsm and one product."""
    return 2 * (kt - 1) + 3 * incpiv_k1(kt)


def complex_library_calls(torch):
    """{driver: (label, fn)}: one PyTorch call computing the same function
    on the driver's own matrix (context only; the port never calls it
    in place of its sweep)."""
    from dplasma_tpu_torch.ops import generators
    n, nb = N_CX, NB_CX
    out = {}
    for p, dt in (("c", torch.complex64), ("z", torch.complex128)):
        H = generators.plghe(float(n), n, nb, seed=3872,
                             dtype=dt).to_dense()
        R = generators.plrnt(n, n, nb, nb, seed=3872, dtype=dt).to_dense()
        R1 = generators.plrnt(n, n, nb, nb, seed=3873, dtype=dt).to_dense()
        Ht = torch.tril(H)
        out.update({
            f"testing_{p}potrf": ("torch.linalg.cholesky",
                                  lambda H=H: torch.linalg.cholesky(H)),
            f"testing_{p}getrf": ("torch.linalg.lu_factor_ex (cuSOLVER)",
                                  lambda R=R: with_cusolver(
                                      torch, torch.linalg.lu_factor_ex, R)),
            f"testing_{p}geqrf": ("torch.geqrf", lambda R=R: torch.geqrf(R)),
            f"testing_{p}herk": ("torch.matmul(a, a^H)",
                                 lambda R=R: torch.matmul(R, R.mH)),
            f"testing_{p}her2k": ("torch.matmul(a, b^H) (one of two)",
                                  lambda R=R, R1=R1: torch.matmul(R, R1.mH)),
            f"testing_{p}hemm": ("torch.addmm", lambda H=H, R=R, R1=R1:
                                 torch.addmm(R1, H, R, beta=0.3, alpha=0.7)),
            f"testing_{p}trsm": ("torch.linalg.solve_triangular",
                                 lambda Ht=Ht, R=R: (
                                     torch.linalg.solve_triangular(
                                         Ht, R, upper=False))),
            f"testing_{p}lanhe": ("torch.linalg.matrix_norm(fro)",
                                  lambda H=H: torch.linalg.matrix_norm(
                                      H, "fro"))})
    A = generators.plrnt(N_LUF, N_LUF, NB_LUF, NB_LUF, seed=3872).to_dense()
    B = generators.plrnt(N_LUF, 1, NB_LUF, NB_LUF, seed=3873).to_dense()
    A64 = generators.plrnt(N_LUF_DD, N_LUF_DD, NB_ZDD, NB_ZDD, seed=3872,
                           dtype=torch.float64).to_dense()
    out.update({
        "testing_sgetrf_incpiv": ("torch.linalg.lu_factor_ex (cuSOLVER)",
                                  lambda: with_cusolver(
                                      torch, torch.linalg.lu_factor_ex, A)),
        "testing_sgesv_incpiv": ("torch.linalg.solve",
                                 lambda: torch.linalg.solve(A, B)),
        "testing_sgetrf_qrf": ("torch.geqrf", lambda: torch.geqrf(A)),
        "testing_dgetrf_incpiv": ("torch.linalg.lu_factor_ex (cuSOLVER, "
                                  "FP64)", lambda: with_cusolver(
                                      torch, torch.linalg.lu_factor_ex,
                                      A64))})
    return out


def phase_complex_lu_family(torch, pk, pdd, dd, record):
    """Phase 14: the c and z drivers natively (K1 is f32/bf16 only, so
    none of them launches a kernel), zpotrf, zgetrf and zgeqrf under
    dd_gemm=always beside native complex128, and the LU family
    (sgetrf_incpiv, sgetrf_qrf --criteria 1, sgesv_incpiv with K1,
    dgetrf_incpiv under dd), each through ``drivers.main`` with every
    count zeroed just before and read just after; one library call
    beside each; every distinct K2 shape of one direct zpotrf, zgetrf,
    zgeqrf and dgetrf_incpiv dd call held bitwise on its own operands
    (the launches as derived, none unfused) and every distinct K1 shape
    of one direct sgetrf_incpiv, getrs_incpiv and getrf_qrf call held to
    gemm_reference, each timed times its count. Returns ({path: K1
    sums}, {path: K2 sums}, K1 driver launches by path, K2 by path)."""
    from dplasma_tpu_torch.ops import generators, lu, qr
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    n, t, tl = str(N_CX), str(NB_CX), str(NB_CX_LU)
    dd_on = {"dd_gemm": "always"}
    # (argv, mca, K1 per run, K2 per run, -x gated)
    runs = []
    for p in "cz":
        runs += [
            ([f"testing_{p}potrf", "-N", n, "-t", t, "-x"], {}, 0, 0, True),
            ([f"testing_{p}getrf", "-N", n, "-t", tl, "-x"], {}, 0, 0,
             True),
            ([f"testing_{p}geqrf", "-N", n, "-t", tl, "-x"], {}, 0, 0,
             True),
            ([f"testing_{p}herk", "-N", n, "-K", n, "-t", t], {}, 0, 0,
             True),
            ([f"testing_{p}her2k", "-N", n, "-K", n, "-t", t], {}, 0, 0,
             True),
            ([f"testing_{p}hemm", "-M", n, "-N", n, "-t", t], {}, 0, 0,
             True),
            ([f"testing_{p}trsm", "-M", n, "-N", n, "-t", t, "-x"], {}, 0,
             0, True),
            ([f"testing_{p}lanhe", "-N", n, "-t", t], {}, 0, 0, True)]
    # -x is logged, not gated, where the route leaves its accuracy
    # envelope in the reference too (ROADMAP queue 3): the complex
    # trsm_f64's Newton inverse in zgetrf dd's solves, the incpiv
    # couples' growth at N = 8192 (f32) and their triangles under dd;
    # the incpiv drivers' -x is gated at N = 4096, where both packages
    # pass
    kz, kzl = N_ZDD // NB_ZDD, N_ZDD_LU // NB_ZDD
    zl, tz = str(N_ZDD_LU), str(NB_ZDD)
    runs += [
        (["testing_zpotrf", "-N", str(N_ZDD), "-t", tz, "-x"], dd_on, 0,
         zpotrf_dd_k2(kz), True),
        (["testing_zgetrf", "-N", zl, "-t", tz, "-x"], dd_on, 0,
         zgetrf_dd_k2(kzl), False),
        (["testing_zgetrf", "-N", zl, "-t", tz, "-x"], {}, 0, 0, True),
        (["testing_zgeqrf", "-N", zl, "-t", tz, "-x"], dd_on, 0,
         zgeqrf_dd_k2(kzl), True),
        (["testing_zgeqrf", "-N", zl, "-t", tz, "-x"], {}, 0, 0, True)]
    kf, kfd = N_LUF // NB_LUF, N_LUF_DD // NB_LUF
    nf, tf, nfd = str(N_LUF), str(NB_LUF), str(N_LUF_DD)
    runs += [
        (["testing_sgetrf_incpiv", "-N", nf, "-t", tf, "-x"], {},
         incpiv_k1(kf), 0, False),
        (["testing_sgetrf_incpiv", "-N", nfd, "-t", tf, "-x"], {},
         incpiv_k1(kfd), 0, True),
        (["testing_sgetrf_qrf", "-N", nf, "-t", tf, "-x", "--criteria",
          "1"], {}, qrf_all_qr_k1(kf), 0, True),
        (["testing_sgesv_incpiv", "-N", nf, "-t", tf, "-x"], {},
         gesv_incpiv_k1(kf), 0, False),
        (["testing_sgesv_incpiv", "-N", nfd, "-t", tf, "-x"], {},
         gesv_incpiv_k1(kfd), 0, True),
        (["testing_dgetrf_incpiv", "-N", nfd, "-t", tf, "-x"], dd_on, 0,
         dincpiv_dd_k2(kfd), False),
        (["testing_dgetrf_incpiv", "-N", nfd, "-t", tf, "-x"], {}, 0, 0,
         True)]
    drivers = {}
    k1_by, k2_by = {}, {}
    for argv, mca, k1w, k2w, gate in runs:
        r = blas3_driver(torch, pk, pdd, argv, mca, k1w, k2w, gate_x=gate)
        key = f"{argv[0]} {' '.join(argv[1:])}" + (" dd" if mca else "")
        drivers[key] = r
        path = argv[0][8:] + ("_dd" if mca else "")
        k1_by[path] = k1_by.get(path, 0) + r["k1_launches_run"]
        k2_by[path] = k2_by.get(path, 0) + r["k2_launches_run"]
        torch.cuda.empty_cache()
    k1_by = {k: v for k, v in k1_by.items() if v}
    k2_by = {k: v for k, v in k2_by.items() if v}
    for prog, sz in (("testing_zpotrf", N_ZDD), ("testing_zgetrf", N_ZDD_LU),
                     ("testing_zgeqrf", N_ZDD_LU),
                     ("testing_dgetrf_incpiv", N_LUF_DD)):
        dd_r = next(r for k, r in drivers.items()
                    if k.startswith(f"{prog} -N {sz} ") and k.endswith(" dd"))
        nat = next(r for k, r in drivers.items()
                   if k.startswith(f"{prog} -N {sz} ")
                   and not k.endswith(" dd"))
        log(f"[{prog}] N={sz}: dd {dd_r['best_s']:.5f} s, native "
            f"{nat['best_s']:.5f} s, dd / native "
            f"{dd_r['best_s'] / nat['best_s']:.1f}x")

    lib = {}
    for prog, (label, fn) in complex_library_calls(torch).items():
        ms = time_ms(torch, fn)
        r = next(r for k, r in drivers.items()
                 if k.startswith(prog + " ") and not k.endswith(" dd"))
        ops = r["ops"]
        best = ops.get(prog + ":F", next(iter(ops.values())))["best_s"]
        log(f"[library] {prog}: {label} {ms:.3f} ms (the driver's best "
            f"{1e3 * best:.3f} ms)")
        lib[prog] = {"call": label, "ms": ms, "driver_ms": 1e3 * best}
    torch.cuda.empty_cache()

    # every distinct K2 shape of one direct dd call, held bitwise on its
    # own operands, the launches as derived, none unfused; then timed
    Az = generators.plghe(float(N_ZDD), N_ZDD, NB_ZDD, seed=3872,
                          dtype=torch.complex128)
    Rz = generators.plrnt(N_ZDD_LU, N_ZDD_LU, NB_ZDD, NB_ZDD, seed=3872,
                          dtype=torch.complex128)
    Rd = generators.plrnt(N_LUF_DD, N_LUF_DD, NB_LUF, NB_LUF, seed=3872,
                          dtype=torch.float64)
    calls = {
        "zpotrf_dd": (lambda: potrf_mod.potrf(Az, "L"), zpotrf_dd_k2(kz),
                      N_ZDD),
        "zgetrf_dd": (lambda: lu.getrf_1d(Rz), zgetrf_dd_k2(kzl), N_ZDD_LU),
        "zgeqrf_dd": (lambda: qr.geqrf(Rz), zgeqrf_dd_k2(kzl), N_ZDD_LU),
        "dgetrf_incpiv_dd": (lambda: lu.getrf_incpiv(Rd), dincpiv_dd_k2(kfd),
                             N_LUF_DD)}
    g = torch.Generator(device="cuda").manual_seed(1500)
    k2_paths = {}
    for path, (run, want, size) in calls.items():
        pdd.reset_counts()
        pk.reset_counts()
        with cfg.override_scope(dd_on):
            seen = recorded_k2_products(torch, pdd, run)
        got = sum(r["count"] for r in seen.values())
        check(got == want == pdd.LAUNCHES and pdd.UNFUSED == 0
              and pk.LAUNCHES == 0,
              f"{path}: {got} K2 launches recorded ({pdd.LAUNCHES} "
              f"counted, want {want}), {pdd.UNFUSED} unfused, "
              f"{pk.LAUNCHES} K1")
        k2_paths[path] = k2_path_sum(torch, dd, pdd, g, path, seen, size)
        torch.cuda.empty_cache()
    del Az, Rz, Rd

    # every distinct K1 shape of the LU family, recorded through the
    # wrapper on one direct call each, held and timed as phase 2 does
    A = generators.plrnt(N_LUF, N_LUF, NB_LUF, NB_LUF, seed=3872)
    B = generators.plrnt(N_LUF, 1, NB_LUF, NB_LUF, seed=3873)
    F = lu.getrf_incpiv(A)
    Q = lu.getrf_qrf(A, criterion="higham_sum", alpha=100.0)
    check(Q[2].tolist() == [0] * kf, f"sgetrf_qrf lu_tab {Q[2].tolist()}")
    k1calls = {
        "sgetrf_incpiv": (lambda: lu.getrf_incpiv(A), incpiv_k1(kf)),
        "sgetrs_incpiv": (lambda: lu.getrs_incpiv(*F, B),
                          incpiv_k1(kf) + kf - 1),
        "sgetrf_qrf": (lambda: lu.getrf_qrf(A, criterion="higham_sum",
                                            alpha=100.0),
                       qrf_all_qr_k1(kf))}
    k1_paths = {}
    for j, (path, (run, want)) in enumerate(k1calls.items()):
        prods = recorded_k1_products(torch, pk, run)
        got = sum(p[-1] for p in prods)
        check(got == want, f"{path}: {got} K1 products recorded, want "
                           f"{want}")
        k1_paths[path] = k1_path_sum(torch, pk, record, path, prods,
                                     1500 + 20 * j)
    del A, B, F, Q
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ffma_ms",
            "products")
    k1_paths["sgesv_incpiv"] = dict(
        {k: k1_paths["sgetrf_incpiv"][k] + k1_paths["sgetrs_incpiv"][k]
         for k in keys},
        max_abs_err=max(k1_paths["sgetrf_incpiv"]["max_abs_err"],
                        k1_paths["sgetrs_incpiv"]["max_abs_err"]))
    torch.cuda.empty_cache()
    record["complex_lu_family"] = {"drivers": drivers, "library": lib,
                                   "k1_paths": k1_paths,
                                   "k2_paths": k2_paths}
    return k1_paths, k2_paths, k1_by, k2_by


# phase 15: the hierarchical QR trees and the LDLᴴ / butterfly solvers at
# the Level-3 BLAS size; z natively and d under dd at 4096, cut for time
N_HQR, NB_HQR = 8192, 512
N_HQR_SMALL = 4096


def hqr_products(tree, kt):
    """Products of one square geqrf_param (ops/hqr.py): a larft Gram per
    GEQRT leader and per couple of every panel, 3 per apply in every
    panel with a trailing slab. Every one has all three dimensions >= nb
    (512 here), above K1's _MIN_DIM of 256."""
    return sum((len(tree.leaders(k)) + len(tree.schedule(k)))
               * (4 if k < kt - 1 else 1) for k in range(kt))


def unm_products(tree, kt):
    """Products of one unmqr_param / unmlq_param: 3 per operation."""
    return 3 * sum(len(tree.leaders(k)) + len(tree.schedule(k))
                   for k in range(kt))


def hetrf_products(kt):
    """ldl.hetrf: one HEDRK product per panel with a trailing block (its
    trsm is cuBLAS's); under dd the trsm_f64's two limb residuals
    more."""
    return kt - 1, 3 * (kt - 1)


def hebut_products(kt, refine=2):
    """rbt.hesv_rbt: hetrf, then 1 + refine hetrs solves of two blocked
    trsm's (kt − 1 products each: the right-hand side is padded to one
    nb-wide tile) and refine residual products A·X."""
    return (kt - 1) + (1 + refine) * 2 * (kt - 1) + refine


def hqr_library_calls(torch):
    """{driver: (label, fn)}: one PyTorch call computing the same function
    on the driver's own matrix (context only: cuSOLVER's geqrf is the
    flat-tree QR, ldl_factor pivots, so neither gives the same bits)."""
    from dplasma_tpu_torch.ops import generators
    n, nb, ns = N_HQR, NB_HQR, N_HQR_SMALL
    A = generators.plrnt(n, n, nb, nb, seed=3872).to_dense()
    At = A.mH.contiguous()
    C = generators.plrnt(n, n, nb, nb, seed=3873).to_dense()
    H = generators.plghe(float(n), n, nb, seed=3872).to_dense()
    B = generators.plrnt(n, 1, nb, nb, seed=3873).to_dense()
    fa, tau = torch.geqrf(A)
    out = {}
    for p in ("geqrf_hqr", "geqrf_systolic", "geqrf_rd"):
        out[f"testing_s{p}"] = ("torch.geqrf", lambda: torch.geqrf(A))
    for p in ("gelqf_hqr", "gelqf_systolic"):
        out[f"testing_s{p}"] = ("torch.geqrf(A^H)",
                                lambda: torch.geqrf(At))
    for p in ("unmqr_hqr", "unmlq_hqr", "unmqr_systolic", "unmlq_systolic"):
        out[f"testing_s{p}"] = ("torch.ormqr",
                                lambda: torch.ormqr(fa, tau, C))
    out["testing_shetrf"] = ("torch.linalg.ldl_factor (pivoted)",
                             lambda: torch.linalg.ldl_factor(H))
    out["testing_shebut"] = ("torch.linalg.solve",
                             lambda: torch.linalg.solve(H, B))
    for p, dt in (("z", torch.complex128), ("d", torch.float64)):
        As = generators.plrnt(ns, ns, nb, nb, seed=3872, dtype=dt).to_dense()
        Hs = generators.plghe(float(ns), ns, nb, seed=3872,
                              dtype=dt).to_dense()
        out[f"testing_{p}geqrf_hqr"] = ("torch.geqrf",
                                        lambda As=As: torch.geqrf(As))
        out[f"testing_{p}hetrf"] = (
            "torch.linalg.ldl_factor (pivoted)",
            lambda Hs=Hs: torch.linalg.ldl_factor(Hs, hermitian=True))
    return out


def phase_hqr_ldl(torch, pk, pdd, dd, record):
    """Phase 15: the hierarchical QR trees, their appliers, pivgen and the
    LDLᴴ / butterfly solvers through ``drivers.main`` with K1 on, every
    count zeroed just before each run and read just after and each timed
    run's K1 / K2 launches held to the ops' derived counts; zgeqrf_hqr,
    zhetrf and the dd dgeqrf_hqr / dhetrf at 4096 (dd beside native
    FP64); one library call beside each driver; every distinct K1
    product of one direct call of each path held to gemm_reference on
    the tensor-core kernel and timed; every K2 launch of one dd
    geqrf_param and hetrf held bitwise and timed; hetrf's host share
    (the diagonal tiles' rank-1 loops) and one shetrf under
    ``torch.profiler``. Returns ({path: K1 sums}, {path: K2 sums}, K1
    driver launches by path, K2 by path)."""
    import contextlib
    import io
    from dplasma_tpu_torch.drivers import main as driver_main
    from dplasma_tpu_torch.ops import generators, hqr, ldl, rbt
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    kt, ks = N_HQR // NB_HQR, N_HQR_SMALL // NB_HQR
    n, t, ns = str(N_HQR), str(NB_HQR), str(N_HQR_SMALL)
    dflt = hqr.hqr_tree(kt, a=1)          # the drivers' default tree
    a4 = hqr.hqr_tree(kt, a=4, hlvl="greedy")
    rd = hqr.svd_tree(kt)
    dd_on = {"dd_gemm": "always"}
    he1, he2 = hetrf_products(kt)
    hs1, hs2 = hetrf_products(ks)
    # (argv, mca, K1 per timed run, K2 per timed run)
    runs = [
        (["testing_sgeqrf_hqr", "-N", n, "-t", t, "-x"], {},
         hqr_products(dflt, kt), 0),
        (["testing_sgeqrf_hqr", "-N", n, "-t", t, "-x", "--qr_a", "4",
          "--treeh", "1"], {}, hqr_products(a4, kt), 0),
        (["testing_sgeqrf_systolic", "-N", n, "-t", t, "-x"], {},
         hqr_products(hqr.systolic_tree(kt), kt), 0),
        (["testing_sgeqrf_rd", "-N", n, "-t", t, "-x"], {},
         hqr_products(rd, kt), 0),
        (["testing_sgelqf_hqr", "-N", n, "-t", t], {},
         hqr_products(dflt, kt), 0),
        (["testing_sgelqf_systolic", "-N", n, "-t", t], {},
         hqr_products(hqr.systolic_tree(kt), kt), 0)]
    for p in ("unmqr_hqr", "unmlq_hqr", "unmqr_systolic", "unmlq_systolic"):
        runs.append(([f"testing_s{p}", "-M", n, "-N", n, "-t", t], {},
                     unm_products(dflt, kt), 0))
    runs += [
        (["testing_shetrf", "-N", n, "-t", t, "-x"], {}, he1, 0),
        (["testing_shebut", "-N", n, "-t", t, "-x"], {},
         hebut_products(kt), 0),
        (["testing_zgeqrf_hqr", "-N", ns, "-t", t, "-x"], {}, 0, 0),
        (["testing_zhetrf", "-N", ns, "-t", t, "-x"], {}, 0, 0),
        (["testing_dgeqrf_hqr", "-N", ns, "-t", t, "-x"], dd_on, 0,
         hqr_products(hqr.hqr_tree(ks, a=1), ks)),
        (["testing_dgeqrf_hqr", "-N", ns, "-t", t, "-x"], {}, 0, 0),
        (["testing_dhetrf", "-N", ns, "-t", t, "-x"], dd_on, 0, hs2),
        (["testing_dhetrf", "-N", ns, "-t", t, "-x"], {}, 0, 0)]
    drivers = {}
    k1_by, k2_by = {}, {}
    for argv, mca, k1w, k2w in runs:
        r = blas3_driver(torch, pk, pdd, argv, mca, k1w, k2w)
        key = f"{argv[0]} {' '.join(argv[1:])}" + (" dd" if mca else "")
        drivers[key] = r
        path = argv[0][8:] + ("_dd" if mca else "")
        k1_by[path] = k1_by.get(path, 0) + r["k1_launches_run"]
        k2_by[path] = k2_by.get(path, 0) + r["k2_launches_run"]
        torch.cuda.empty_cache()
    k1_by = {k: v for k, v in k1_by.items() if v}
    k2_by = {k: v for k, v in k2_by.items() if v}
    for prog in ("testing_dgeqrf_hqr", "testing_dhetrf"):
        dd_r = drivers[f"{prog} -N {ns} -t {t} -x dd"]
        nat = drivers[f"{prog} -N {ns} -t {t} -x"]
        log(f"[{prog}] N={ns}: dd {dd_r['best_s']:.5f} s, native FP64 "
            f"{nat['best_s']:.5f} s, dd / FP64 "
            f"{dd_r['best_s'] / nat['best_s']:.1f}x")
    # pivgen times nothing: it checks the 94 trees of its grid
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver_main(["testing_spivgen", "-N", n, "-t", t])
    line = next((ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("#+ pivgen:")), "")
    log(f"[testing_spivgen] -N {n} -t {t}: {line}")
    check(rc == 0 and line.startswith(f"#+ pivgen: 94 trees checked OK "
                                      f"(MT={kt})"),
          f"testing_spivgen exited {rc}: {line!r}")

    lib = {}
    for prog, (label, fn) in hqr_library_calls(torch).items():
        ms = time_ms(torch, fn, reps=1 if "ldl" in label else 3)
        r = next(r for k, r in drivers.items()
                 if k.startswith(prog + " ") and not k.endswith(" dd"))
        best = r["best_s"]
        log(f"[library] {prog}: {label} {ms:.3f} ms (the driver's best "
            f"{1e3 * best:.3f} ms)")
        lib[prog] = {"call": label, "ms": ms, "driver_ms": 1e3 * best}
    torch.cuda.empty_cache()

    # every distinct K1 product of one direct call of each path, recorded
    # through the wrapper, held and timed once, summed per path
    A = generators.plrnt(N_HQR, N_HQR, NB_HQR, NB_HQR, seed=3872)
    C = generators.plrnt(N_HQR, N_HQR, NB_HQR, NB_HQR, seed=3873)
    H = generators.plghe(float(N_HQR), N_HQR, NB_HQR, seed=3872)
    B = generators.plrnt(N_HQR, 1, NB_HQR, NB_HQR, seed=3873)
    Fq = hqr.geqrf_param(dflt, A)
    Fl = hqr.gelqf_param(dflt, A)
    calls = {
        "sgeqrf_hqr": (lambda: hqr.geqrf_param(dflt, A),
                       hqr_products(dflt, kt)),
        "sgeqrf_hqr_a4": (lambda: hqr.geqrf_param(a4, A),
                          hqr_products(a4, kt)),
        "sgeqrf_rd": (lambda: hqr.geqrf_param(rd, A), hqr_products(rd, kt)),
        "sgelqf_hqr": (lambda: hqr.gelqf_param(dflt, A),
                       hqr_products(dflt, kt)),
        "sunmqr_hqr": (lambda: hqr.unmqr_param(dflt, "L", "N", *Fq, C),
                       unm_products(dflt, kt)),
        "sunmlq_hqr": (lambda: hqr.unmlq_param(dflt, "L", "N", *Fl, C),
                       unm_products(dflt, kt)),
        "shetrf": (lambda: ldl.hetrf(H), he1),
        "shebut": (lambda: rbt.hesv_rbt(H, B, "L", seed=3872, depth=1),
                   hebut_products(kt))}
    recorded = {}
    for path, (run, want) in calls.items():
        prods = recorded_k1_products(torch, pk, run)
        got = sum(p[-1] for p in prods)
        check(got == want, f"{path}: {got} K1 products recorded, want "
                           f"{want}")
        recorded[path] = prods
    shared = {}
    k1_paths = {path: k1_path_sum(torch, pk, record, path, prods, 1600,
                                  cache=shared)
                for path, prods in recorded.items()}
    log(f"[k1] phase 15: {len(shared)} distinct K1 products held and "
        f"timed")
    del A, C, Fq, Fl
    torch.cuda.empty_cache()

    # every K2 launch of one dd geqrf_param and one dd hetrf at 4096,
    # bitwise on its own operands, then timed times its count
    A64 = generators.plrnt(N_HQR_SMALL, N_HQR_SMALL, NB_HQR, NB_HQR,
                           seed=3872, dtype=torch.float64)
    H64 = generators.plghe(float(N_HQR_SMALL), N_HQR_SMALL, NB_HQR,
                           seed=3872, dtype=torch.float64)
    ts = hqr.hqr_tree(ks, a=1)
    g = torch.Generator(device="cuda").manual_seed(1600)
    k2_paths = {}
    for path, (run, want) in {
            "dgeqrf_hqr_dd": (lambda: hqr.geqrf_param(ts, A64),
                              hqr_products(ts, ks)),
            "dhetrf_dd": (lambda: ldl.hetrf(H64), hs2)}.items():
        pdd.reset_counts()
        pk.reset_counts()
        with cfg.override_scope(dd_on):
            seen = recorded_k2_products(torch, pdd, run)
        got = sum(r["count"] for r in seen.values())
        check(got == want == pdd.LAUNCHES and pdd.UNFUSED == 0
              and pk.LAUNCHES == 0,
              f"{path}: {got} K2 launches recorded ({pdd.LAUNCHES} "
              f"counted, want {want}), {pdd.UNFUSED} unfused, "
              f"{pk.LAUNCHES} K1")
        k2_paths[path] = k2_path_sum(torch, dd, pdd, g, path, seen,
                                     N_HQR_SMALL)
        torch.cuda.empty_cache()
    del A64, H64

    # hetrf's host share: the diagonal tiles' nb-step rank-1 loops, each
    # timed with a synchronize around it, against the whole call timed
    # the same way (and, apart, the call without the synchronizes)
    orig = ldl.hetrf_tile
    tile_s = []

    def timed_tile(a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(a)
        torch.cuda.synchronize()
        tile_s.append(time.perf_counter() - t0)
        return out

    ldl.hetrf(H)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ldl.hetrf(H)
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    ldl.hetrf_tile = timed_tile
    try:
        t0 = time.perf_counter()
        ldl.hetrf(H)
        torch.cuda.synchronize()
        synced = time.perf_counter() - t0
    finally:
        ldl.hetrf_tile = orig
    tiles = sum(tile_s)
    log(f"[shetrf] N={N_HQR} nb={NB_HQR}: one hetrf {1e3 * whole:.2f} ms "
        f"({1e3 * synced:.2f} ms with a synchronize around each diagonal "
        f"tile); its {len(tile_s)} tiles' rank-1 loops "
        f"({len(tile_s) * (NB_HQR - 1)} steps) {1e3 * tiles:.2f} ms of "
        f"that, {100 * tiles / synced:.1f}%")
    _profile(torch, record, "shetrf_profile", f"N={N_HQR} nb={NB_HQR}",
             lambda: ldl.hetrf(H))
    del H, B
    torch.cuda.empty_cache()
    record["hqr_ldl"] = {"drivers": drivers, "library": lib,
                         "k1_paths": k1_paths, "k2_paths": k2_paths,
                         "pivgen": line,
                         "hetrf_host": {"whole_ms": 1e3 * whole,
                                        "synced_ms": 1e3 * synced,
                                        "tile_loops_ms": 1e3 * tiles,
                                        "tiles": len(tile_s)}}
    return k1_paths, k2_paths, k1_by, k2_by


# ---------------------------------------------------------------------
# phase 16: the eigen/SVD chain (herbt, hbrdt, hetrd, heev, gebrd_ge2gb,
# gebrd, gesvd) with kernels KT (tridiagonal bisection) and KW (the SBR
# sweeps with b <= 128, one launch a sweep)
N_EIG, NB_EIG = 8192, 256
N_EIG_SMALL = 2048       # KW's d, c and z replays, the dhetrd KT case
N_EIG_RECT = 4096        # the short side of the rectangular sgesvd runs
# the d, c, z and dd drivers: cut from 4096 to keep the script well
# inside its time limit on a slow host (it took 908 s of 1200 at 4096)
N_EIG_DRIVERS = 2048
N_EIG_ROUTES = 512       # both routes of every narrow sweep on real data
# the Givens chase, logged: ~800 us a rotation on the card (eager, ~30
# launches each), so N=512's 126480 rotations took 107 s in this phase
# (PERF.md §6): cut to N=128 (7812 rotations) for the script's time
N_CHASE, B_CHASE = 128, 32
KW_EVERY = 389          # the replay holds KW at t = 0, T - 1 and t % 389 == 0
KW_TOL64 = 1e-11         # KW vs plain in f64 / c128, max|Δ| / max|plain|
# every held window slot: max|KW − reference| over its strips at most
# KW_COND · eps · κ · max|reference|, κ the condition of its QR block. A
# block close to rank deficiency leaves its last reflectors to rounding
# noise (in complex a tiny last pivot sets a row's phase), so the step's
# forward error grows with κ in any precision and any route. Measured
# on an H100 over every replay: KW at most 4.6, the f32/c64 plain
# version 3.1 (PERF.md §6)
KW_COND = 16.0
KW_RANK = 1e-10          # singular values below this share: exact zeros
# f32 / c64 also: over the held steps of a sweep, the median of KW's
# distance to the step in twice the precision over the plain version's
KW_RATIO = 4.0
FP64_FLOPS = 34e12       # CUDA-core FP64 (H100 SXM data sheet)


def _eig_ok(*dims):
    return int(min(dims) >= 256)


def herbt_products(n, nb, gated=True):
    """Products of one herbt (ops/eig.py): larft and the two applies, 7 a
    panel; with ``gated`` only those with every dimension >= 256 (K1's
    gate), else all (the dd route takes every f64 product)."""
    mp = -(-n // nb) * nb
    return sum(7 * (_eig_ok(nb, mp - s - nb) if gated else 1)
               for s in range(0, n - nb - 1, nb) if s + nb < mp)


def ge2gb_products(m, n, nb, gated=True):
    """Products of one gebrd_ge2gb: per panel the QR's larft and its
    3-product apply to the columns right of it, the LQ's larft and its
    apply to the rows below."""
    mp, np_ = -(-m // nb) * nb, -(-n // nb) * nb
    ok = _eig_ok if gated else (lambda *d: 1)
    tot = 0
    for kk in range(min(mp, np_) // nb):
        s, e = kk * nb, (kk + 1) * nb
        tot += ok(nb, mp - s)
        if e < np_:
            tot += 3 * ok(nb, mp - s, np_ - e) + ok(nb, np_ - e)
            if e < mp:
                tot += 3 * ok(mp - e, np_ - e, nb)
    return tot


def herm_chain_counts(band, n, b, dtype):
    """(K1, KW launches, KW steps) of one herm_band_to_tridiag_scan from
    band b: KW one launch a sweep it takes (b <= 128) over all the
    sweep's steps, K1 seven a live window of a sweep whose window
    products pass K1's gate."""
    k1 = kw = steps = 0
    b = min(b, max(n - 1, 1))
    if n <= 2 or b <= 1:
        return 0, 0, 0
    for bb, w in band.sweep_ladder(b):
        sch = band._sbr_banded_schedule(n, bb, w)
        if sch is None:
            continue
        route = band._route("auto", bb, dtype, 3 * bb + w, "herm")
        kw += route == "kw"
        steps += sch[2] if route == "kw" else 0
        k1 += 7 * int((sch[1] > 0).sum()) if route == "k1" else 0
    return k1, kw, steps


def bidiag_chain_counts(band, m, n, nb, dtype):
    """(K1, KW launches, KW steps) of one bidiag_band_to_bidiag_scan of
    gebrd's band (2nb − 1): KW one launch a sweep it takes, K1 four a
    live window of a sweep whose window products pass the gate."""
    k1 = kw = steps = 0
    b = min(2 * nb - 1, max(n - 1, 1))
    K = min(m, n)
    for bb, w in band.sweep_ladder(b):
        sch = band._sbr_schedule_bidiag(K, bb, w, m < n)
        if sch is None or K <= 1:
            continue
        route = band._route("auto", bb, dtype, 3 * bb + w, "bidiag")
        kw += route == "kw"
        steps += sch[3] if route == "kw" else 0
        k1 += 4 * int((sch[1] > 0).sum()) if route == "k1" else 0
    return k1, kw, steps


def eig_wants(torch, band, algo, m, n, nb, dtype, dd=False):
    """{k1, k2, kw, kt} launches and the KW steps (kw_steps) of one
    timed run of ``algo``, derived from ops/eig.py and the sweep
    schedules (K1 on, f32 only; K2 under dd, every f64 stage-1
    product)."""
    f32 = dtype == torch.float32
    w = {"k1": 0, "k2": 0, "kw": 0, "kt": 0, "kw_steps": 0}
    if algo == "heev":
        return w
    if algo in ("hetrd", "hbrdt", "heev2"):
        b = nb if algo != "hbrdt" else 2 * nb - 1
        k1, w["kw"], w["kw_steps"] = herm_chain_counts(band, n, b, dtype)
        stage1 = 0 if algo == "hbrdt" else 1
        w["k1"] = (k1 + stage1 * herbt_products(n, nb)) if f32 else 0
        w["k2"] = stage1 * herbt_products(n, nb, gated=False) if dd else 0
        w["kt"] = int(algo == "heev2")
        return w
    g1 = ge2gb_products(m, n, nb) if f32 else 0
    w["k2"] = ge2gb_products(m, n, nb, gated=False) if dd else 0
    if algo == "gebrd_ge2gb":
        w["k1"] = g1
        return w
    k1, w["kw"], w["kw_steps"] = bidiag_chain_counts(band, m, n, nb, dtype)
    w["k1"] = (g1 + k1) if f32 else 0
    w["kt"] = int(algo == "gesvd")
    return w


def eig_driver(torch, pk, pdd, argv, mca, want):
    """One eig driver run through ``blas3_driver`` (K1/K2 held, -x gated;
    the KW and KT counts, too, zeroed just before and read just after),
    then each timed run's KW and KT launches and KW steps held to
    ``want``."""
    from dplasma_tpu_torch.drivers import common
    from dplasma_tpu_torch.kernels import sbr, tridiag
    sbr.reset_counts()
    tridiag.reset_counts()
    r = blas3_driver(torch, pk, pdd, argv, mca, want["k1"], want["k2"])
    kw_run, kt_run, steps_run = sbr.LAUNCHES, tridiag.LAUNCHES, sbr.STEPS
    op = common.RUNS[-1]["ops"][0]
    for lab in ("kw_launches", "kt_launches", "kw_steps"):
        key = lab.replace("_launches", "")
        check(all(x == want[key] for x in op[lab]),
              f"{argv[0]}: {lab} {op[lab]} (want {want[key]})")
    log(f"[{argv[0]}] {' '.join(argv[1:])}: per timed run K1 "
        f"{op['k1_launches']} K2 {op['k2_launches']} KW {op['kw_launches']}"
        f" over {op['kw_steps']} steps, KT {op['kt_launches']} (derived "
        f"{want}); in the run KW {kw_run} over {steps_run} steps, KT "
        f"{kt_run}")
    r.update(kw_launches=op["kw_launches"], kt_launches=op["kt_launches"],
             kw_steps=op["kw_steps"], kw_launches_run=kw_run,
             kw_steps_run=steps_run, kt_launches_run=kt_run, want=want)
    return r


def _t_norm(torch, d, e):
    a = e.abs().double()
    row = torch.cat([a[:1], a[:-1] + a[1:], a[-1:]]) if a.numel() else 0
    dd = d.double()
    return float(torch.maximum((dd + row).abs().max(),
                               (dd - row).abs().max()))


def kt_bound_ms_per_search(n, dtype, iters):
    """The bound of one search a value, no tree shared: n Sturm
    sequences of n steps per level, four operations each at the
    CUDA-core rate of the type, or the 3n values moved."""
    isz = 4 if dtype == "float32" else 8
    t_ops = 4.0 * n * n * iters / (FP32_FLOPS if isz == 4 else FP64_FLOPS)
    t_bytes = 3.0 * n * isz / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


H100_SMS = 132
MUFU_PER_CLK = 16        # MUFU results a clock an SM (sm_90)
DFMA_PER_CLK = 64        # FP64 FMAs a clock an SM (sm_90)


def kt_rates(torch):
    """What the division term of KT's bound reads off this card and this
    build: the card's max SM clock (nvidia-smi clocks.max.sm, MHz) and
    the FP64-pipe instructions (DFMA, DMUL, DADD) on the fast path of
    the compiled IEEE double division (the SASS of ``kt_ddiv_probe``
    before its first EXIT, by the toolkit's cuobjdump)."""
    from torch.utils.cpp_extension import CUDA_HOME
    from dplasma_tpu_torch.kernels import _build
    out = {"sm_clock_max_mhz": None, "ddiv_dfma": None, "ddiv_fp64_ops":
           None, "ddiv_sass": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    try:
        out["sm_clock_max_mhz"] = float(smi.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        pass
    _build.load("tridiag_bisect")
    sass = subprocess.run(
        [os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"),
         "-sass", "-fun", "kt_ddiv_probe",
         str(_build._target("tridiag_bisect"))],
        capture_output=True, text=True, timeout=120)
    body = sass.stdout.split("EXIT")[0]
    ops = []
    for ln in body.splitlines():
        # "/*0080*/  @!P0 MUFU.RCP64H R5, R3 ;  /* 0x... */"
        toks = ln.split("*/")[1].split() if ln.count("*/") >= 2 else []
        toks = [t for t in toks if not t.startswith("@")]
        if toks:
            ops.append(toks[0])
    if sass.returncode == 0 and "MUFU.RCP64H" in body:
        out["ddiv_dfma"] = sum(o.startswith("DFMA") for o in ops)
        out["ddiv_fp64_ops"] = sum(o.startswith(("DFMA", "DMUL", "DADD"))
                                   for o in ops)
        out["ddiv_sass"] = [o for o in ops if o.startswith(
            ("DFMA", "DMUL", "DADD", "MUFU"))]
    check(out["sm_clock_max_mhz"] is not None,
          f"KT bound: the max SM clock unread ({smi.stdout!r})")
    check(bool(out["ddiv_fp64_ops"]),
          f"KT bound: the f64 division's SASS unread (cuobjdump rc "
          f"{sass.returncode}, MUFU.RCP64H in it "
          f"{'MUFU.RCP64H' in body})")
    log(f"[kt] card rates: max SM clock {out['sm_clock_max_mhz']} MHz; "
        f"IEEE double division: {out['ddiv_dfma']} DFMA, "
        f"{out['ddiv_fp64_ops']} FP64-pipe instructions on its fast path "
        f"({out['ddiv_sass']}; cuobjdump rc {sass.returncode})")
    return out


def kt_bound_ms(n, dtype, iters, m, rates):
    """The least time for this output on a shared tree: (2^D − 1 +
    (iters − D)·m) Sturm sequences of n steps (one node a level a target
    below a top tree of D levels), at the D that makes it least (⌈log₂
    m⌉: each level past it adds 2^D − m), whatever the launch's plan;
    the largest of the operations term (four a step at the type's
    CUDA-core rate), the division term (f32: one MUFU reciprocal a step
    at 16 a clock an SM; f64: the compiled division's FP64-pipe
    instructions, its DFMAs and DMUL, at 64 a clock an SM; at the card's
    max SM clock) and the bytes term (2n inputs, m outputs). Returns
    (ms, by, terms, depth)."""
    isz = 4 if dtype == "float32" else 8
    depth = min(range(iters + 1),
                key=lambda D: (1 << D) - 1 + (iters - D) * m)
    steps = float((1 << depth) - 1 + (iters - depth) * m) * n
    t_ops = 4.0 * steps / (FP32_FLOPS if isz == 4 else FP64_FLOPS)
    clk = rates["sm_clock_max_mhz"] * 1e6
    per = (MUFU_PER_CLK if isz == 4
           else DFMA_PER_CLK / rates["ddiv_fp64_ops"])
    t_div = steps / (H100_SMS * per * clk)
    t_bytes = (2.0 * n + m) * isz / HBM_BYTES_S
    terms = {"operations": t_ops, "division": t_div, "bytes": t_bytes}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by, {k: 1e3 * v for k, v in terms.items()}, \
        depth


KT_SAMPLE = 64           # indices the host's plain version bisects for
# (depth, s) plans timed beside tridiag.plan's on shetrd's tridiagonal: a
# top tree of ⌈log₂ n⌉ levels with rounds of 3 and 4, and one level more
# than the default's
KT_PLANS = ((13, 3), (13, 4), (16, 3))


def kt_targets(torch, n):
    """The eigenvalue indices a sampled check holds: KT_SAMPLE spread
    over [0, n) and the five around the middle (a Jordan–Wielandt
    tridiagonal's zero eigenvalue and its smallest ± pairs)."""
    k = torch.linspace(0, n - 1, KT_SAMPLE).round().to(torch.int32)
    mid = torch.arange(n // 2 - 2, n // 2 + 3, dtype=torch.int32)
    return torch.unique(torch.cat([k, mid.clamp(0, n - 1)]))


def kt_case(torch, tridiag, key, d, e, plain_on, rates, library=True,
            keep=None, plans=()):
    """KT on (d, e) on the card, held ``torch.equal`` to its plain
    version and within 2·eps·t_norm of it (on the card over every index,
    or ``plain_on`` "host": on the host over kt_targets' sample) and
    ascending; KT timed beside its bound (and the per-search one) and
    (``library``) torch.linalg.eigvalsh of the dense tridiagonal.
    ``keep``: the top ``keep`` indices gesvd asks for, launched and
    timed too (the case's ``ms``; the whole spectrum's is ``full_ms``),
    held ``torch.equal`` to the full launch there. ``plans``: (depth, s)
    pairs launched for the whole spectrum beside ``tridiag.plan``'s, each
    held ``torch.equal`` to it and timed. Returns the case's record."""
    n, dt = d.shape[0], d.dtype
    tridiag.reset_counts()
    got = tridiag.eigh_tridiagonal(d, e)
    torch.cuda.synchronize()
    check(tridiag.LAUNCHES == 1, f"KT: {tridiag.LAUNCHES} launches")
    ks = None if plain_on == "card" else kt_targets(torch, n)
    dev = "cuda" if plain_on == "card" else "cpu"
    t0 = time.perf_counter()
    want = tridiag.eigh_tridiagonal_reference(d.to(dev), e.to(dev),
                                              targets=ks)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    tn = _t_norm(torch, d, e)
    eps = torch.finfo(dt).eps
    held = got.cpu() if ks is None else got.cpu()[ks.long()]
    err = float((held - want.cpu()).abs().max())
    equal = bool(torch.equal(held, want.cpu()))
    asc = bool((got[1:] >= got[:-1]).all())
    check(equal and err <= 2 * eps * tn and asc,
          f"KT {key}: kernel equal to plain {equal}, |kernel - plain| "
          f"{err:.3e} (2 eps t_norm {2 * eps * tn:.3e}), ascending {asc}")
    iters = tridiag.max_levels(dt)
    full_ms = time_ms(torch, lambda: tridiag.eigh_tridiagonal(d, e), reps=5)
    rec = {"n": n, "max_abs_err": err, "equal": equal,
           "eps_t_norm": eps * tn, "ascending": asc, "full_ms": full_ms,
           "plain_ms": 1e3 * plain_s, "plain_on": plain_on,
           "plain_indices": n if ks is None else int(ks.numel()),
           "library_ms": None}
    m, ms = n, full_ms
    if keep:
        m = keep
        tg = torch.arange(n - keep, n, dtype=torch.int32, device=d.device)
        tridiag.reset_counts()
        top = tridiag.eigh_tridiagonal(d, e, targets=tg)
        torch.cuda.synchronize()
        check(tridiag.LAUNCHES == 1, f"KT {key} targets: "
              f"{tridiag.LAUNCHES} launches")
        same = bool(torch.equal(top, got[n - keep:]))
        check(same, f"KT {key}: the {keep} targets differ from the full "
              f"launch")
        ms = time_ms(torch, lambda: tridiag.eigh_tridiagonal(d, e,
                                                             targets=tg),
                     reps=5)
        rec.update(targets=keep, targets_equal_full=same)
    pl = tridiag.plan(n, m, dt)
    bound, by, terms, bdepth = kt_bound_ms(n, str(dt).split(".")[-1],
                                           iters, m, rates)
    old, old_by = kt_bound_ms_per_search(n, str(dt).split(".")[-1],
                                         iters)
    rec.update(ms=ms, plan=pl._asdict(), bound_ms=bound, bound_by=by,
               bound_terms_ms=terms, bound_depth=bdepth,
               bound_ms_per_search=old, bound_by_per_search=old_by)
    plan_txt = ""
    if plans:
        # the default plan beside others, the same bits from each
        rec["plans_ms"] = {str(tuple(pl)): full_ms}
        for alt in plans:
            alt = tridiag.Plan(alt[0], alt[1], pl.resident)
            other = tridiag._launch(d, e, None, alt)
            check(bool(torch.equal(other, got)),
                  f"KT {key}: plan {tuple(alt)} differs from {tuple(pl)}")
            rec["plans_ms"][str(tuple(alt))] = time_ms(
                torch, lambda: tridiag._launch(d, e, None, alt), reps=5)
        plan_txt = "; plans (depth, s, resident), all equal: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in rec["plans_ms"].items())
    lib_txt = "not timed"
    if library:
        T = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
        lib = {}

        def dense():
            lib["w"] = torch.linalg.eigvalsh(T)

        rec["library_ms"] = time_ms(torch, dense, reps=1)
        w64 = (lib["w"] if dt == torch.float64 else
               torch.linalg.eigvalsh(T.double()) if n <= N_EIG else None)
        del T, lib
        lib_txt = f"{rec['library_ms']:.3f} ms"
        if w64 is not None:
            rec["vs_eigvalsh64"] = float((got.double() - w64).abs().max())
            lib_txt += f", |kernel - eigvalsh f64| {rec['vs_eigvalsh64']:.3e}"
    tg_txt = (f"; its top {keep} (gesvd's targets) {ms:.3f} ms, equal to "
              f"the full launch there" if keep else "")
    log(f"[kt] {key}: kernel equal to plain {equal}, |kernel - plain| "
        f"{err:.3e} ({err / (eps * tn):.2f} eps t_norm) over "
        f"{rec['plain_indices']} of {n} indices, ascending {asc}; kernel "
        f"{full_ms:.3f} ms for all {n} values{tg_txt}; plan {tuple(pl)}; "
        f"plain {1e3 * plain_s:.1f} ms (on the {plain_on}); bound "
        f"{bound:.3f} ms ({by}; terms {terms}; per search {old:.3f} ms, "
        f"{old_by}; the tree's least depth {bdepth}); eigvalsh of the "
        f"dense tridiagonal {lib_txt}{plan_txt}")
    torch.cuda.empty_cache()
    return rec


def phase_kt(torch, tridiag, eig, generators, record):
    """KT against its plain version on the (d, e) of one s hetrd at
    N=8192 (the kernel line's shape, heev 2stage's), the same cast to
    f64 (timed beside eigvalsh at 8192 in f64) and one d hetrd at
    N=N_EIG_SMALL, the plain version on the host over a sample of indices (on
    the card over every index the s case took 24.9 s, cut for the
    script's time), and on edge cases, ``torch.equal`` and within
    2·eps·t_norm, its results ascending; timed beside
    torch.linalg.eigvalsh of the dense tridiagonal and its bound.
    gesvd's Jordan–Wielandt tridiagonals are held after the drivers
    (:func:`phase_kt_jw`)."""
    out = {"cases": {}, "rates": kt_rates(torch)}
    for prec, dt, where, n in (("s", torch.float32, "host", N_EIG),
                               ("d", torch.float64, "host", N_EIG_SMALL)):
        A = generators.plghe(0.0, n, NB_EIG, seed=3872, dtype=dt)
        d, e = eig.hetrd(A)
        del A
        torch.cuda.empty_cache()
        out["cases"][f"{prec}hetrd_{n}"] = kt_case(
            torch, tridiag, f"{prec}hetrd_{n}", d, e, where, out["rates"],
            plans=KT_PLANS if prec == "s" else ())
        if prec == "s":
            out["cases"][f"shetrd_{n}_as_f64"] = kt_case(
                torch, tridiag, f"shetrd_{n}_as_f64", d.double(),
                e.double(), where, out["rates"])
    rng = torch.Generator().manual_seed(1601)
    m = 10
    edge = {
        "n1": (torch.tensor([2.5]), torch.zeros(0)),
        "n2": (torch.tensor([1.0, -3.0]), torch.tensor([0.75])),
        "e0": (torch.randn(64, generator=rng), torch.zeros(63)),
        "wilkinson21": (torch.arange(-m, m + 1).abs().double(),
                        torch.ones(2 * m)),
        "jordan_wielandt": (torch.zeros(301),
                            torch.rand(300, generator=rng) + 0.1)}
    for name, (d0, e0) in edge.items():
        for dt in (torch.float32, torch.float64):
            d, e = d0.to(dt).cuda(), e0.to(dt).cuda()
            got = tridiag.eigh_tridiagonal(d, e)
            want = tridiag.eigh_tridiagonal_reference(d, e)
            tn = _t_norm(torch, d, e) if d.numel() > 1 else abs(float(d[0]))
            eps = torch.finfo(dt).eps
            err = float((got - want).abs().max())
            equal = bool(torch.equal(got, want))
            asc = bool((got[1:] >= got[:-1]).all()) if got.numel() > 1 \
                else True
            check(equal and err <= 2 * eps * max(tn, 1e-30) and asc,
                  f"KT edge case {name} {dt}: equal {equal}, {err:.3e}, "
                  f"ascending {asc}")
            out["cases"][f"{name}_{str(dt)[-7:]}"] = {
                "n": d.numel(), "max_abs_err": err, "equal": equal}
            log(f"[kt] {name} {str(dt)[6:]} n={d.numel()}: kernel equal "
                f"to plain {equal}, |kernel - plain| {err:.3e}, "
                f"ascending {asc}")
    return out


def phase_kt_jw(torch, tridiag, jw, rates):
    """KT on the Jordan–Wielandt tridiagonals that gesvd driver runs of
    phase 16 handed it (captured from those runs: a zero diagonal of
    length L + 1 and the interleaved [d1, e1, d2, ...]), held against
    the plain version on the host over a sample of indices, its top K
    (the values gesvd asks for) ``torch.equal`` to the full launch's
    there, both timed beside the bound; the sgesvd one also beside
    eigvalsh of the dense tridiagonal (n = 16384 f32, 1 GiB)."""
    return {key: kt_case(torch, tridiag, key, d, e, "host", rates,
                         library=key.startswith("sgesvd"), keep=k)
            for key, (d, e, k) in jw.items()}


def _rand_like_storage(torch, shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, dtype=dtype, device="cuda", generator=g)


def _wide(torch, dt):
    return {torch.float32: torch.float64,
            torch.complex64: torch.complex128}.get(dt)


def _kw_compare(torch, got, plain, plain_wide):
    """Whole-storage distances of one replayed step: f64/c128 |KW −
    plain| relative; f32/c64 KW's distance to the step in twice the
    precision, beside the plain version's own distance to it."""
    if plain_wide is None:
        scale = float(plain.abs().max())
        kw = float((got - plain).abs().max())
        return kw / scale, 0.0, kw
    scale = float(plain_wide.abs().max())
    kw = float((got.to(plain_wide.dtype) - plain_wide).abs().max())
    pl = float((plain.to(plain_wide.dtype) - plain_wide).abs().max()) / scale
    return kw / scale, pl, kw


def _kw_strips(torch, sbr, kind, X, geom, bs, tabs, t, qr):
    """(G, ·): the elements step t reads and writes, per window slot
    (the herm step's row and column strips, the bidiag step's rows or
    columns)."""
    G = geom.G
    if kind == "herm":
        R, C = sbr.herm_views(X, bs, geom)
        return torch.cat([R.reshape(G, -1), C.reshape(G, -1)], 1)
    idx = sbr.bidiag_index(tabs.c0[t], tabs.off[t], geom, qr)
    return X.view(-1)[idx].reshape(G, -1)


def _kw_kappa(torch, sbr, kind, X, geom, bs, tabs, t, qr):
    """(G,) the condition of each slot's QR block in X before step t:
    its largest singular value over its smallest above KW_RANK of it (a
    masked column or a row past the matrix is an exact zero, which the
    QR passes through with tau = 0, not a small pivot); 1 for an
    all-zero block."""
    b = geom.b
    if kind == "herm":
        R, _ = sbr.herm_views(X, bs, geom)
        blk = sbr.masked_block(R, tabs.u[t], b)
    else:
        W = X.view(-1)[sbr.bidiag_index(tabs.c0[t], tabs.off[t], geom, qr)]
        if qr:
            blk = W[:, :, :b]
        else:
            rows = torch.arange(b, device=X.device)
            keep = (rows[None, :] < tabs.u[t][:, None])[:, :, None]
            blk = torch.where(keep, W[:, :b, :], torch.zeros(
                (), dtype=X.dtype, device=X.device)).conj().mT
    sv = torch.linalg.svdvals(blk)
    s0 = sv[:, 0]
    smin = torch.where(sv > KW_RANK * s0[:, None], sv,
                       torch.full_like(sv, float("inf"))).amin(1)
    return torch.where(s0 > 0, s0 / smin, torch.ones_like(s0))


def _kw_sweep_ms(torch, sbr, kind, X, tabs, T, geom, form=None):
    """One launch of KW over the whole sweep on X, timed by CUDA
    events."""
    run = sbr.herm_steps if kind == "herm" else sbr.bidiag_steps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(X, tabs, 0, T, geom, form)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def kw_replay(torch, band, sbr, kind, m, n, b, w, dtype, seed):
    """Every step of one sweep on random storage of the main path's
    geometry through KW, one launch a step; at t = 0, T − 1 and every
    KW_EVERY-th step the plain version runs the same step on a copy of
    the same input (and, for f32/c64, in twice the precision: the
    reference) and every window slot is held on its own: max|KW −
    reference| over the slot's strips at most KW_COND · eps · κ ·
    max|reference|, κ the condition of the slot's QR block
    (:func:`_kw_kappa`). f64/c128 are also held to KW_TOL64 over the
    whole storage. Then the whole sweep in ONE launch on the same input,
    timed, held bitwise (torch.equal) to the step-by-step launches; a
    narrow sweep also in its other form (warp or block), both forms
    timed in the order A B B A and each run held bitwise to the first."""
    wide = _wide(torch, dtype)
    eps = torch.finfo(dtype).eps
    if kind == "herm":
        base, us, T, G, S, V, L0, hi = band._sbr_banded_schedule(n, b, w)
        D = 2 * b + w
        H = 2 * D + 1
        shape = (L0 + max(hi, n) + S, H)
        geom = sbr.HermGeom(G, S, V, b, H, D)
        tabs = sbr.herm_tabs(base + L0, us, geom, "cuda")
        bases = (base + L0).tolist()

        def kernel(X, t):
            sbr.herm_step(X, tabs, t, geom)

        def plain(X, t):
            sbr.herm_step_reference(X, bases[t], tabs.u[t], geom)
    else:
        K = min(m, n)
        c0s, us, offs, T, G, V, park0 = band._sbr_schedule_bidiag(
            K, b, w, m < n)
        lim = park0 + G * V
        shape = (max(lim, m), max(lim, n))
        geom = sbr.BidiagGeom(G, V, b, shape[1])
        tabs = sbr.bidiag_tabs(c0s, us, offs, geom, "cuda")
        bases = [0] * T

        def kernel(X, t):
            sbr.bidiag_step(X, tabs, t, geom)

        def plain(X, t):
            sbr.bidiag_step_reference(X, tabs.c0[t], tabs.u[t], tabs.off[t],
                                      geom, t % 2 == 1)

    def storage():
        X = _rand_like_storage(torch, shape, dtype, seed)
        if kind == "bidiag":
            X[m:] = 0
            X[:, n:] = 0
        return X

    def strips(X, t):
        return _kw_strips(torch, sbr, kind, X, geom, bases[t], tabs, t,
                          t % 2 == 1)

    pl = sbr.plan(b, V, dtype, kind)
    X = storage()
    worst_kw = worst_pl = worst_abs = 0.0
    checked = windows = 0
    plain_ms = 0.0
    ratios = []
    cond = {"kw": 0.0, "plain": 0.0, "kappa_at_kw": 1.0, "kappa_max": 1.0}
    worst_step = {}
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    for t in range(T):
        held = t in (0, T - 1) or t % KW_EVERY == 0
        if held:
            Xp = X.clone()
            ev[0].record()
            plain(Xp, t)
            ev[1].record()
            torch.cuda.synchronize()
            plain_ms += ev[0].elapsed_time(ev[1])
            Xw = ref = None
            if wide is not None:
                Xw = X.to(wide)
                kappa = _kw_kappa(torch, sbr, kind, Xw, geom, bases[t], tabs,
                                  t, t % 2 == 1)
                plain(Xw, t)
                ref = Xw
            else:
                kappa = _kw_kappa(torch, sbr, kind, X, geom, bases[t], tabs,
                                  t, t % 2 == 1)
                ref = Xp
        kernel(X, t)
        if held:
            e_kw, e_pl, a_kw = _kw_compare(torch, X, Xp, Xw)
            worst_kw, worst_pl = max(worst_kw, e_kw), max(worst_pl, e_pl)
            worst_abs = max(worst_abs, a_kw)
            checked += 1
            sr = strips(ref, t)
            den = torch.clamp(eps * kappa * sr.abs().amax(1),
                              min=torch.finfo(kappa.dtype).tiny)
            d_kw = (strips(X, t).to(sr.dtype) - sr).abs().amax(1)
            r_kw = d_kw / den
            r_pl = ((strips(Xp, t).to(sr.dtype) - sr).abs().amax(1) / den
                    if wide is not None else torch.zeros_like(r_kw))
            g = int(r_kw.argmax())
            step_max = float(r_kw[g])
            windows += int((kappa < float("inf")).sum())
            if step_max > cond["kw"]:
                cond.update(kw=step_max, kappa_at_kw=float(kappa[g]))
            cond["plain"] = max(cond["plain"], float(r_pl.max()))
            fin = kappa[kappa < float("inf")]
            if fin.numel():
                cond["kappa_max"] = max(cond["kappa_max"], float(fin.max()))
            if e_kw >= worst_step.get("rel", -1.0):
                gd = int(d_kw.argmax())
                worst_step = {"t": t, "rel": e_kw, "plain_rel": e_pl,
                              "kappa": float(kappa[gd]),
                              "ratio": float(r_kw[gd])}
            ok = (step_max <= KW_COND
                  and bool(torch.isfinite(X).all())
                  and (wide is not None or e_kw <= KW_TOL64))
            check(ok, f"KW {kind} {dtype} {m}x{n} {b}->{w} step {t}: slot "
                      f"{g} max|KW - reference| / (eps kappa max|reference|)"
                      f" {step_max:.3g} (kappa {float(kappa[g]):.3g}, "
                      f"bound {KW_COND:g}); storage |KW - reference| "
                      f"{e_kw:.3e} (plain {e_pl:.3e})")
            if wide is not None:
                ratios.append(e_kw / max(e_pl, eps))
            del Xp, Xw, ref
    median = sorted(ratios)[len(ratios) // 2] if ratios else 0.0
    check(median <= KW_RATIO,
          f"KW {kind} {dtype} {m}x{n} {b}->{w}: median of KW's distance "
          f"to the {wide} step over the plain version's {median:.2f}")
    # the whole sweep in one launch, on the same input: bitwise the steps
    Y = storage()
    launches, steps = sbr.LAUNCHES, sbr.STEPS
    ms = _kw_sweep_ms(torch, sbr, kind, Y, tabs, T, geom)
    check((sbr.LAUNCHES - launches, sbr.STEPS - steps) == (1, T),
          f"KW {kind} {b}->{w}: the sweep took {sbr.LAUNCHES - launches} "
          f"launches over {sbr.STEPS - steps} steps (want 1 over {T})")
    same = bool(torch.equal(X, Y))
    check(same, f"KW {kind} {dtype} {m}x{n} {b}->{w}: the sweep's one "
                f"launch differs from its {T} one-step launches")
    del X
    # a narrow sweep in both forms, timed in the order A B B A (A the one
    # plan takes, timed above; B's kernel loaded by one step first), each
    # run bitwise the first
    other, other_ms, form_ms = None, None, {pl.form: [ms]}
    if b <= sbr.WARP_MAX_B:
        other = "block" if pl.form == "warp" else "warp"
        form_ms[other] = []
        run = sbr.herm_steps if kind == "herm" else sbr.bidiag_steps
        run(storage(), tabs, 0, 1, geom, other)
        for f in (other, other, pl.form):
            Z = storage()
            form_ms[f].append(_kw_sweep_ms(torch, sbr, kind, Z, tabs, T,
                                           geom, form=f))
            check(bool(torch.equal(Y, Z)),
                  f"KW {kind} {dtype} {b}->{w}: the {f} form's sweep "
                  f"differs from the {pl.form} form's first")
            del Z
        other_ms = sum(form_ms[other]) / 2
    del Y, tabs
    torch.cuda.empty_cache()
    isz = torch.empty((), dtype=dtype).element_size()
    nbytes, flops = kw_sweep_cost(band, kind, m, n, b, w, isz,
                                  dtype.is_complex)
    peak = FP32_FLOPS if dtype in (torch.float32, torch.complex64) \
        else FP64_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    rec = {"kind": kind, "m": m, "n": n, "b": b, "w": w,
           "dtype": str(dtype), "steps": T, "slots": G,
           "form": pl.form, "ncta": pl.ncta, "threads": pl.threads,
           "smem": pl.smem,
           "live_windows": int((us > 0).sum()), "checked": checked,
           "windows_held": windows,
           "worst_kw": worst_kw, "worst_plain": worst_pl,
           "median_ratio": median, "max_abs_err": worst_abs,
           "worst_cond_kw": cond["kw"], "worst_cond_plain": cond["plain"],
           "kappa_at_worst_cond": cond["kappa_at_kw"],
           "kappa_max": cond["kappa_max"], "worst_step": worst_step,
           "one_launch_equal": same, "sweep_ms": ms, "step_us": 1e3 * ms / T,
           "other_form": other, "other_form_ms": other_ms,
           "form_ms": form_ms, "plain_ms_held": plain_ms, "plain_step_us": 1e3 * plain_ms /
           max(checked, 1),
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops}
    ref_txt = "plain" if wide is None else str(wide)[6:] + " plain"
    blk = ("" if other is None else
           f"; the two forms in the order A B B A, ms: {pl.form} "
           + " / ".join(f"{x:.2f}" for x in form_ms[pl.form])
           + f", {other} " + " / ".join(f"{x:.2f}" for x in form_ms[other])
           + f" (mean {other_ms:.2f}, {1e3 * other_ms / T:.2f} us a step; "
           f"bitwise the {pl.form} form's)")
    log(f"[kw] replay {kind} {str(dtype)[6:]} {m}x{n} {b}->{w}: T={T} "
        f"G={G} ({pl.form}, {pl.ncta} CTA, {pl.threads} threads, "
        f"{pl.smem} B), {checked} steps held, {windows} slots each within "
        f"{KW_COND:g} eps kappa of the {ref_txt} step: worst KW "
        f"{cond['kw']:.3g} (kappa {cond['kappa_at_kw']:.3g}), plain "
        f"{cond['plain']:.3g}, largest kappa {cond['kappa_max']:.3g}; over "
        f"the storage worst KW {worst_kw:.3e} plain {worst_pl:.3e} (median "
        f"ratio {median:.2f} <= {KW_RATIO:g}), the worst step t="
        f"{worst_step.get('t')}: slot kappa {worst_step.get('kappa', 0):.3g}"
        f", {worst_step.get('ratio', 0):.3g} eps kappa; the sweep in one "
        f"launch {ms:.2f} ms, {rec['step_us']:.2f} us a step, torch.equal "
        f"to its {T} one-step launches {same}{blk}; bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); the plain version "
        f"{plain_ms:.1f} ms over the {checked} held steps, "
        f"{rec['plain_step_us']:.1f} us a step")
    return rec


def kw_barrier_us(torch, band, sbr):
    """µs a step of KW's grid barrier alone: the f32 bidiagonal 7→1
    sweep of an N_EIG sgebrd in one launch with every slot parked (u = 0:
    a window returns at once), so a step is the barrier and the table
    reads; the most per-slot step flags could save. Mean of 3 launches
    after one."""
    K, b, w = N_EIG, 7, 1
    c0s, us, offs, T, G, V, park0 = band._sbr_schedule_bidiag(K, b, w,
                                                              False)
    lim = park0 + G * V
    X = torch.zeros((max(lim, K), max(lim, K)), device="cuda")
    geom = sbr.BidiagGeom(G, V, b, X.shape[1])
    tabs = sbr.bidiag_tabs(c0s, 0 * us, offs, geom, "cuda")
    ms = time_ms(torch, lambda: sbr.bidiag_steps(X, tabs, 0, T, geom))
    check(not bool(X.any()), "KW: a parked sweep wrote to X")
    out = {"steps": T, "slots": G, "ms": ms, "us_a_step": 1e3 * ms / T}
    log(f"[kw] the grid barrier alone: the bidiag {b}->{w} sweep at "
        f"N={K} with every slot parked, {T} steps over {G} slots in one "
        f"launch {ms:.3f} ms, {out['us_a_step']:.3f} us a step")
    del X, tabs
    return out


def kw_sweep_cost(band, kind, m, n, b, w, isz, cplx):
    """(bytes, flops) one sweep must move and do: per live window
    the strips read once and written once (herm: the b×V row strip read,
    it and the V×b column strip written; bidiag: one b×V strip each
    way), and the reflectors' applies: reflector j of a window of width u
    (j < u) spans b − j elements and meets the V − j − 1 lines past its
    pivot, a dot and an update each, 4·(b − j) real flops a line (x4
    complex); the herm step adds its b×b right pass, b rows more."""
    import numpy as np
    f = 4 if cplx else 1
    if kind == "herm":
        base, us, T, G, S, V, L0, hi = band._sbr_banded_schedule(n, b, w)
        extra, nbytes = b, 3.0 * b * V * isz
    else:
        K = min(m, n)
        c0s, us, offs, T, G, V, park0 = band._sbr_schedule_bidiag(
            K, b, w, m < n)
        extra, nbytes = 0, 2.0 * b * V * isz
    j = np.arange(b, dtype=np.float64)
    upto = np.concatenate([[0.0], np.cumsum(4.0 * (b - j)
                                            * (V - 1 - j + extra))])
    live = us[us > 0]
    return nbytes * live.size, f * float(upto[live].sum())


def phase_kw_routes(torch, band, sbr, eig, generators, record):
    """The sweeps KW takes (b <= 128) of one shetrd and one sgebrd at
    N_EIG_ROUTES on real data through KW and through the plain version:
    the spectra of the two tridiagonals (bidiagonals) held to each other
    and to the dense solver's; both routes' sweeps timed (KW's ms and
    plain_ms in the kernel line) beside their bound."""
    n, nb = N_EIG_ROUTES, NB_EIG
    A = generators.plghe(0.0, n, nb, seed=3872)
    Bm, _, _ = eig.herbt(A)
    G = generators.plrnt(n, n, nb, nb, seed=3872)
    Bg = eig.gebrd_ge2gb(G)
    times = {"kw": 0.0, "plain": 0.0}
    cost = [0.0, 0.0]

    def timed(route, sweep):
        def run(*a):
            kind = "bidiag" if len(a) == 5 else "herm"
            b, w = a[-2:] if kind == "bidiag" else a[2:4]
            if not sbr.eligible(b, 3 * b + w, a[0].dtype, kind):
                return sweep(*a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sweep(*a, route=route)
            torch.cuda.synchronize()
            times[route] += time.perf_counter() - t0
            return out
        return run

    spectra = {}
    for route in ("kw", "plain"):
        d, e = band.herm_band_to_tridiag_scan(
            Bm.data, n, nb,
            sweep=lambda F, N, b, w, D, L0: timed(
                route, band.herm_sbr_sweep_banded)(F, N, b, w, D, L0))
        T = (torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)).double()
        spectra[("herm", route)] = torch.linalg.eigvalsh(T)
        d, e = band.bidiag_band_to_bidiag_scan(
            Bg.data, n, n, 2 * nb - 1,
            sweep=lambda X, M, N, b, w: timed(
                route, band.bidiag_sbr_sweep)(X, M, N, b, w))
        Bb = (torch.diag(d) + torch.diag(e, 1)).double()
        spectra[("bidiag", route)] = torch.linalg.svdvals(Bb)
    ref_h = torch.linalg.eigvalsh(A.to_dense().double())
    ref_b = torch.linalg.svdvals(G.to_dense().double())
    out = {}
    eps = torch.finfo(torch.float32).eps
    for kind, ref in (("herm", ref_h), ("bidiag", ref_b)):
        a = torch.sort(spectra[(kind, "kw")]).values
        p = torch.sort(spectra[(kind, "plain")]).values
        r = torch.sort(ref).values
        scale = float(r.abs().max())
        kw_p = float((a - p).abs().max()) / scale
        kw_r = float((a - r).abs().max()) / scale
        pl_r = float((p - r).abs().max()) / scale
        check(kw_p <= 60 * eps * n and kw_r <= 60 * eps * n,
              f"KW {kind} chain N={n}: spectrum vs plain route {kw_p:.3e}, "
              f"vs the dense solver {kw_r:.3e}")
        out[kind] = {"kw_vs_plain": kw_p, "kw_vs_dense": kw_r,
                     "plain_vs_dense": pl_r}
        log(f"[kw] real {kind} chain N={n}: spectrum through KW vs through "
            f"the plain version {kw_p:.3e}, KW vs the f64 dense solver "
            f"{kw_r:.3e}, plain vs it {pl_r:.3e} (relative to the largest)")
    for kind, b0 in (("herm", nb), ("bidiag", 2 * nb - 1)):
        for bb, w in band.sweep_ladder(b0):
            if sbr.eligible(bb, 3 * bb + w, torch.float32, kind):
                c = kw_sweep_cost(band, kind, n, n, bb, w, 4, False)
                cost[0] += c[0]
                cost[1] += c[1]
    t_bytes, t_ops = cost[0] / HBM_BYTES_S, cost[1] / FP32_FLOPS
    out.update(ms=1e3 * times["kw"], plain_ms=1e3 * times["plain"],
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=cost[0], flops=cost[1])
    log(f"[kw] the KW sweeps of one shetrd and one sgebrd (N={n}, "
        f"nb={nb}): KW {out['ms']:.1f} ms, plain {out['plain_ms']:.1f} ms "
        f"(host clock around each sweep, synchronized), bound "
        f"{out['bound_ms']:.3f} ms ({out['bound_by']}: {cost[0] / 1e9:.2f} "
        f"GB, {cost[1] / 1e9:.2f} GFLOP)")
    return out


def prebuild_schedules(band, algo, m, n, nb):
    """Build on the host every sweep schedule of ``algo``'s chain at
    (m, n, nb), as a driver's warm-up run would, so that its timed run
    builds none (each sweep copies its tables to the card itself)."""
    if algo in ("hetrd", "hbrdt", "heev2"):
        b = nb if algo != "hbrdt" else 2 * nb - 1
        for bb, w in band.sweep_ladder(min(b, n - 1)):
            band._sbr_banded_schedule(n, bb, w)
    elif algo in ("gebrd", "gesvd"):
        for bb, w in band.sweep_ladder(min(2 * nb - 1, n - 1)):
            band._sbr_schedule_bidiag(min(m, n), bb, w, m < n)


def geqrf_batched_vs_loop(torch, band):
    """The window QR of the plain and K1 routes (band._live_factor) at
    the chains' sweeps with b > 32 at N_EIG, f32 / f64 / c128, per step:
    one batched torch.geqrf over the G window slots (the plain route
    below LOOP_QR_MIN_B), one batched call over the step's mean number
    of live windows only, and a loop of 2-D calls over them (the plain
    and K1 routes from LOOP_QR_MIN_B), each timed by CUDA events (mean
    of 5 after a warm-up); the measurement behind band.LOOP_QR_MIN_B."""
    out = []
    shapes = []
    for kind, b0 in (("herm", NB_EIG), ("bidiag", 2 * NB_EIG - 1)):
        for bb, w in band.sweep_ladder(b0):
            if bb > 32:
                us = (band._sbr_banded_schedule(N_EIG, bb, w)[1]
                      if kind == "herm" else
                      band._sbr_schedule_bidiag(N_EIG, bb, w, False)[1])
                live = max(1, round(float((us > 0).sum(1).mean())))
                shapes.append((kind, us.shape[1], live, bb))
    g = torch.Generator(device="cuda").manual_seed(1690)
    for dt in (torch.float32, torch.float64, torch.complex128):
        for kind, G, live, b in shapes:
            x = torch.randn(G, b, b, dtype=dt, device="cuda", generator=g)
            xl = x[:live].contiguous()
            t_b = time_ms(torch, lambda: torch.geqrf(x), reps=5)
            t_lb = time_ms(torch, lambda: torch.geqrf(xl), reps=5)
            t_l = time_ms(torch, lambda: [torch.geqrf(x[i])
                                          for i in range(live)], reps=5)
            takes = "loop" if b >= band.LOOP_QR_MIN_B else "batched"
            out.append({"dtype": str(dt), "sweep": kind, "G": G,
                        "live": live, "b": b, "batched_ms": t_b,
                        "live_batched_ms": t_lb, "loop_ms": t_l,
                        "takes": takes})
            log(f"[geqrf] {str(dt)[6:]} {kind} b={b}, a step: batched over "
                f"its G={G} slots {t_b:.3f} ms, batched over its mean {live} "
                f"live windows {t_lb:.3f} ms, loop of 2-D over them "
                f"{t_l:.3f} ms; the plain and K1 routes take the {takes} "
                f"form (LOOP_QR_MIN_B {band.LOOP_QR_MIN_B})")
            del x, xl
    torch.cuda.empty_cache()
    return out


def _sync_calls(torch):
    """A context whose value is the list of warnings raised inside it,
    with PyTorch's sync debug mode on: each of torch's synchronising
    CUDA calls (a blocking copy between host and card, ``.item()``)
    adds one (:func:`_n_syncs`); kernels launched through ctypes and the
    caching allocator's own calls are not seen."""
    import contextlib
    import warnings

    @contextlib.contextmanager
    def ctx():
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield seen
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    return ctx()


def _n_syncs(seen):
    return sum("synchroniz" in str(w.message) for w in seen)


#: live windows in the profiled slice of a K1-route sweep's steps
K1_SLICE_WINDOWS = 48


def k1_route_idle(torch, band, kind, args):
    """The device's idle share on the K1 route of a chain's first sweep
    (``kind`` "herm", ``args`` (F, N, b, w, D, L0); "bidiag", (X, M, N,
    b, w)), on a slice of its steps: from the first whose live windows
    reach the sweep's mean, K1_SLICE_WINDOWS windows long. The steps
    before it run untimed; the slice runs twice from the same input,
    once timed by CUDA events and the host clock with torch's
    synchronising calls counted, once under torch.profiler for the
    device's busy time. The idle share is 1 − busy / the unprofiled
    span. Returns its record."""
    import contextlib

    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    if kind == "herm":
        F, N, b, w, D, L0 = args
        us = band._sbr_banded_schedule(N, b, w)[1]

        def steps():
            return band.herm_sweep_steps(F.clone(), N, b, w, D, L0,
                                         route="k1")
    else:
        X, M, N, b, w = args
        us = band._sbr_schedule_bidiag(min(M, N), b, w, M < N)[1]

        def steps():
            return band.bidiag_sweep_steps(X, M, N, b, w, route="k1")
    live = (np.asarray(us) != 0).sum(1)
    t0 = int(np.argmax(live >= live.mean()))
    t1 = min(len(live), t0 + 1 + int(np.searchsorted(
        np.cumsum(live[t0:]), K1_SLICE_WINDOWS)))

    def run(prof):
        gen = steps()
        for _ in range(t0):
            next(gen)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if prof else contextlib.nullcontext())
        with ctx as p, _sync_calls(torch) as seen:
            ev[0].record()
            h0 = time.perf_counter()
            for _ in range(t1 - t0):
                next(gen)
            host = 1e3 * (time.perf_counter() - h0)
            ev[1].record()
            torch.cuda.synchronize()
        gen.close()
        by_kernel = {}
        if prof:
            cuda = torch.autograd.DeviceType.CUDA
            for x in p.events():
                if x.device_type == cuda and _device_ms(x):
                    by_kernel[x.name] = (by_kernel.get(x.name, 0.0)
                                         + _device_ms(x))
        return ev[0].elapsed_time(ev[1]), host, _n_syncs(seen), by_kernel

    span, host, syncs, _ = run(False)
    pspan, phost, _, by_kernel = run(True)
    busy = sum(by_kernel.values())
    check(busy > 0, f"K1 route {kind} {b}->{w}: the profiler recorded "
          f"no device time")
    cats = dict(sorted(_by_category(by_kernel).items(),
                       key=lambda kv: -kv[1]))
    wins = int(live[t0:t1].sum())
    rec = {"kind": kind, "b": b, "w": w, "steps": [t0, t1],
           "windows": wins, "span_ms": span, "host_ms": host,
           "syncs": syncs, "busy_ms": busy, "idle_share": 1 - busy / span,
           "profiled_span_ms": pspan, "profiled_host_ms": phost,
           "categories_ms": cats}
    log(f"[stages]   K1 route {kind} {b}->{w}, steps {t0}..{t1 - 1} of "
        f"{len(live)} ({wins} live windows): device span {span:.1f} ms, "
        f"host {host:.1f} ms with {syncs} synchronising calls; device busy "
        f"{busy:.1f} ms (torch.profiler; span {pspan:.1f}, host {phost:.1f} "
        f"under it): idle share {100 * rec['idle_share']:.1f}%; a window "
        f"{span / wins:.2f} ms of span, {busy / wins:.2f} ms busy; busy by "
        f"category: " + ", ".join(f"{c} {ms:.1f} ms" for c, ms in
                                  list(cats.items())[:5]))
    return rec


def eig_stage_times(torch, pk, sbr, tridiag, band, eig, algo, A):
    """One ``eig.heev(A, method="2stage")`` (``algo`` "heev2") or
    ``eig.gesvd(A)`` ("gesvd") with each stage timed by CUDA events on
    the stream and by the host clock, with torch's synchronising calls
    in it counted (:func:`_sync_calls`): a stage's host time includes
    its waits at them (a table upload waits for the stages before it),
    so it is the time the host spent issuing the stage only where it
    counts none. Stages: stage 1 (herbt / gebrd_ge2gb), the band scan
    (hbrdt's, with its band set-up; the bidiagonal one) and inside it
    each sweep of the ladder with its route and launches, then KT.
    Counts zeroed just before, read just after. The first sweep on the
    K1 route is kept and its device idle share measured after the run
    (:func:`k1_route_idle`). Returns (record, launches)."""
    rows = []
    kept = {}

    def counts():
        return {"k1": pk.LAUNCHES, "kw": sbr.LAUNCHES,
                "kt": tridiag.LAUNCHES, "kw_steps": sbr.STEPS}

    def timed(name, fn, route=None, keep=None):
        def run(*a, **kw):
            row = {"stage": name(*a) if callable(name) else name,
                   "route": route(*a) if callable(route) else route}
            if keep and row["route"] == "k1" and keep not in kept:
                kept[keep] = (a[0].clone(),) + a[1:]
            rows.append(row)
            c0 = counts()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            row["w0"] = len(seen)
            ev[0].record()
            h0 = time.perf_counter()
            out = fn(*a, **kw)
            row["host_ms"] = 1e3 * (time.perf_counter() - h0)
            ev[1].record()
            row["w1"] = len(seen)
            c1 = counts()
            row["launches"] = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
            row["ev"] = ev
            return out
        return run

    def herm_route(F, N, b, w, D, L0):
        return band._route("auto", b, F.dtype, 3 * b + w, "herm")

    def bidiag_route(X, M, N, b, w):
        return band._route("auto", b, X.dtype, 3 * b + w, "bidiag")

    saved = {(eig, "herbt"): eig.herbt,
             (eig, "gebrd_ge2gb"): eig.gebrd_ge2gb,
             (band, "herm_band_to_tridiag_scan"):
                 band.herm_band_to_tridiag_scan,
             (band, "bidiag_band_to_bidiag_scan"):
                 band.bidiag_band_to_bidiag_scan,
             (tridiag, "eigh_tridiagonal"): tridiag.eigh_tridiagonal}
    herm_sweep = timed(lambda F, N, b, w, D, L0: f"sweep herm {b}->{w}",
                       band.herm_sbr_sweep_banded, herm_route, "herm")
    bidiag_sweep = timed(lambda X, M, N, b, w: f"sweep bidiag {b}->{w}",
                         band.bidiag_sbr_sweep, bidiag_route, "bidiag")
    hscan, bscan = (saved[(band, "herm_band_to_tridiag_scan")],
                    saved[(band, "bidiag_band_to_bidiag_scan")])
    eig.herbt = timed("stage 1 herbt", eig.herbt)
    eig.gebrd_ge2gb = timed("stage 1 gebrd_ge2gb", eig.gebrd_ge2gb)
    band.herm_band_to_tridiag_scan = timed(
        "hbrdt scan (band set-up and sweeps)",
        lambda X, N, b: hscan(X, N, b, sweep=herm_sweep))
    band.bidiag_band_to_bidiag_scan = timed(
        "bidiag scan (sweeps)",
        lambda X, M, N, b: bscan(X, M, N, b, sweep=bidiag_sweep))
    tridiag.eigh_tridiagonal = timed("KT", tridiag.eigh_tridiagonal)
    for mod in (pk, sbr, tridiag):
        mod.reset_counts()
    seen = []
    try:
        torch.cuda.synchronize()
        with _sync_calls(torch) as seen:
            t0 = time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            w = (eig.heev(A, method="2stage") if algo == "heev2"
                 else eig.gesvd(A))
            e1.record()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    got = counts()
    check(bool(torch.isfinite(w).all()), f"{algo} stage run: not finite")
    for r in rows:
        ev = r.pop("ev")
        r["device_ms"] = ev[0].elapsed_time(ev[1])
        r["syncs"] = _n_syncs(seen[r.pop("w0"):r.pop("w1")])
    span = e0.elapsed_time(e1)
    top = [r for r in rows if not r["stage"].startswith("sweep")]
    rec = {"algo": algo, "n": A.desc.N, "nb": A.desc.nb, "wall_s": wall,
           "host_s": host, "syncs": _n_syncs(seen),
           "device_span_ms": span, "stages": rows,
           "outside_stages_ms": span - sum(r["device_ms"] for r in top),
           "launches": got}
    log(f"[stages] {algo} N={A.desc.N} nb={A.desc.nb}: wall {wall:.3f} s "
        f"(host {host:.3f} s, {rec['syncs']} synchronising calls), device "
        f"span {span:.1f} ms, outside the stages "
        f"{rec['outside_stages_ms']:.1f} ms; launches {got}")
    for r in rows:
        log(f"[stages]   {r['stage']}"
            f"{' (' + r['route'] + ')' if r['route'] else ''}: device "
            f"{r['device_ms']:.1f} ms, host {r['host_ms']:.1f} ms with "
            f"{r['syncs']} synchronising calls, launches {r['launches']}")
    for kind, args in kept.items():
        rec["k1_route"] = k1_route_idle(torch, band, kind, args)
    del kept
    torch.cuda.empty_cache()
    return rec, got


def phase_eig(torch, pk, pdd, record):
    """Phase 16: the eigen/SVD chain. KT and KW against their plain
    versions; the six drivers through ``drivers.main`` with K1 on, every
    count zeroed just before each run and read just after and each timed
    run's K1 / K2 / KW / KT launches held to the counts derived from
    ops/eig.py and the sweep schedules; direct calls (heev 2stage beside
    eigvalsh, the Givens chase, K1's window products held) and one
    shetrd under torch.profiler. Returns its record."""
    from dplasma_tpu_torch.descriptors import BandMatrix
    from dplasma_tpu_torch.kernels import sbr, tridiag
    from dplasma_tpu_torch.ops import band, eig, generators

    pk.enable(True)
    rec = {}
    t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        now = time.perf_counter()
        log(f"[eig] {what}: {now - t0:.1f} s")
        rec.setdefault("section_s", {})[what] = now - t0
        t0 = now

    rec["kt"] = phase_kt(torch, tridiag, eig, generators, record)
    lap("KT against its plain version")
    # KW replayed on random storage: every sweep it takes of one shetrd
    # and one sgebrd (herm 64, 16, 4; bidiag 127, 31, 7) at 8192 in f32,
    # c, d and z at 4096, and of the Hermitian ladder of shbrdt's 511-wide
    # band (herm 127, 31, 7) at 8192 in f32; each also timed in one launch
    reps = []
    for dt, n in ((torch.float32, N_EIG), (torch.complex64, N_EIG_SMALL),
                  (torch.float64, N_EIG_SMALL),
                  (torch.complex128, N_EIG_SMALL)):
        ladders = [("herm", NB_EIG, 1700), ("bidiag", 2 * NB_EIG - 1, 1800)]
        if dt == torch.float32:
            ladders.append(("herm", 2 * NB_EIG - 1, 1900))
        for kind, b0, seed in ladders:
            for bb, w in band.sweep_ladder(b0):
                if sbr.eligible(bb, 3 * bb + w, dt, kind):
                    reps.append(kw_replay(torch, band, sbr, kind, n, n, bb,
                                          w, dt, seed + bb))
    rec["kw_replay"] = reps
    rec["kw_barrier"] = kw_barrier_us(torch, band, sbr)
    lap("KW replays")
    rec["kw_routes"] = phase_kw_routes(torch, band, sbr, eig, generators,
                                       record)
    lap("KW and the plain route on real chains")
    rec["geqrf"] = geqrf_batched_vs_loop(torch, band)
    lap("batched geqrf against a loop of 2-D calls")

    # the drivers, each one timed run: the schedules of its shape are
    # built just before it (what its warm-up run would build), so no
    # timed run builds one
    n, t, ns, nd = (str(N_EIG), str(NB_EIG), str(N_EIG_RECT),
                    str(N_EIG_DRIVERS))
    f32 = torch.float32
    dts = {"s": f32, "d": torch.float64, "c": torch.complex64,
           "z": torch.complex128}
    once = ["--nowarmup"]
    runs = [
        (["testing_sheev", "-N", n, "-t", t, "-x"] + once, {},
         ("heev", N_EIG, N_EIG, f32)),
        (["testing_shetrd", "-N", n, "-t", t] + once, {},
         ("hetrd", N_EIG, N_EIG, f32)),
        (["testing_shbrdt", "-N", n, "-t", t, "-x"] + once, {},
         ("hbrdt", N_EIG, N_EIG, f32)),
        (["testing_sgebrd", "-N", n, "-t", t] + once, {},
         ("gebrd", N_EIG, N_EIG, f32)),
        (["testing_sgesvd", "-N", n, "-t", t, "-x"] + once, {},
         ("gesvd", N_EIG, N_EIG, f32)),
        (["testing_sgebrd_ge2gb", "-N", n, "-t", t, "-x"] + once, {},
         ("gebrd_ge2gb", N_EIG, N_EIG, f32)),
        (["testing_sgesvd", "-M", n, "-N", ns, "-t", t, "-x"] + once, {},
         ("gesvd", N_EIG, N_EIG_RECT, f32)),
        (["testing_sgesvd", "-M", ns, "-N", n, "-t", t, "-x"] + once, {},
         ("gesvd", N_EIG_RECT, N_EIG, f32))]
    for p in ("d", "c", "z"):
        runs += [
            ([f"testing_{p}hetrd", "-N", nd, "-t", t] + once, {},
             ("hetrd", N_EIG_DRIVERS, N_EIG_DRIVERS, dts[p])),
            ([f"testing_{p}gesvd", "-N", nd, "-t", t, "-x"] + once, {},
             ("gesvd", N_EIG_DRIVERS, N_EIG_DRIVERS, dts[p]))]
    dd_on = {"dd_gemm": "always"}
    runs += [
        (["testing_dhetrd", "-N", nd, "-t", t] + once, dd_on,
         ("hetrd", N_EIG_DRIVERS, N_EIG_DRIVERS, torch.float64)),
        (["testing_dgesvd", "-N", nd, "-t", t, "-x"] + once, dd_on,
         ("gesvd", N_EIG_DRIVERS, N_EIG_DRIVERS, torch.float64))]
    # the Jordan–Wielandt tridiagonals KT gets in these runs, captured
    jw_from = {("testing_sgesvd", "-N", n): "sgesvd_jw",
               ("testing_dgesvd", "-N", nd): "dgesvd_jw"}
    jw = {}
    kt_wrapper = tridiag.eigh_tridiagonal

    def kt_capture(label):
        def capture(d, e, targets=None):
            k = None if targets is None else targets.shape[0]
            jw[f"{label}_{d.shape[0]}"] = (d.clone(), e.clone(), k)
            return kt_wrapper(d, e, targets=targets)
        return capture

    drivers = {}
    k1_by, k2_by = {}, {}
    kw_total = kt_total = steps_total = 0
    for argv, mca, (algo, mm, nn, dt) in runs:
        want = eig_wants(torch, band, algo, mm, nn, NB_EIG, dt, dd=bool(mca))
        prebuild_schedules(band, algo, mm, nn, NB_EIG)
        label = None if mca else jw_from.get(tuple(argv[:3]))
        if label:
            tridiag.eigh_tridiagonal = kt_capture(label)
        try:
            r = eig_driver(torch, pk, pdd, argv, mca, want)
        finally:
            tridiag.eigh_tridiagonal = kt_wrapper
        key = f"{argv[0]} {' '.join(argv[1:])}" + (" dd" if mca else "")
        drivers[key] = r
        path = argv[0][8:] + ("_dd" if mca else "")
        k1_by[path] = k1_by.get(path, 0) + r["k1_launches_run"]
        k2_by[path] = k2_by.get(path, 0) + r["k2_launches_run"]
        kw_total += r["kw_launches_run"]
        kt_total += r["kt_launches_run"]
        steps_total += r["kw_steps_run"]
        torch.cuda.empty_cache()
    for prog in ("testing_dhetrd", "testing_dgesvd"):
        x = " -x" if prog.endswith("gesvd") else ""
        dd_r = drivers[f"{prog} -N {nd} -t {t}{x} --nowarmup dd"]
        nat = drivers[f"{prog} -N {nd} -t {t}{x} --nowarmup"]
        log(f"[{prog}] N={nd}: dd {dd_r['best_s']:.5f} s, native FP64 "
            f"{nat['best_s']:.5f} s, dd / FP64 "
            f"{dd_r['best_s'] / nat['best_s']:.2f}x")
    rec["drivers"] = drivers
    lap("the drivers")
    check(sorted(jw) == [f"dgesvd_jw_{2 * N_EIG_DRIVERS}",
                         f"sgesvd_jw_{2 * N_EIG}"],
          f"KT: captured Jordan–Wielandt tridiagonals {sorted(jw)}")
    rec["kt"]["cases"].update(phase_kt_jw(torch, tridiag, jw,
                                          rec["kt"]["rates"]))
    del jw
    lap("KT on the gesvd drivers' Jordan–Wielandt tridiagonals")

    # direct calls: heev 2stage, its K1 products recorded (the recorder
    # calls the wrapper: the launches count), then timed beside eigvalsh
    A = generators.plghe(0.0, N_EIG, NB_EIG, seed=3872)
    want = eig_wants(torch, band, "heev2", N_EIG, N_EIG, NB_EIG, f32)

    def counts():
        return {"k1": pk.LAUNCHES, "kw": sbr.LAUNCHES, "kt": tridiag.LAUNCHES,
                "kw_steps": sbr.STEPS}

    def zero():
        for mod in (pk, sbr, tridiag):
            mod.reset_counts()

    zero()
    prods = recorded_k1_products(torch, pk,
                                 lambda: eig.heev(A, method="2stage"))
    got = counts()
    zero()
    t1 = time.perf_counter()
    w = eig.heev(A, method="2stage")
    torch.cuda.synchronize()
    two = time.perf_counter() - t1
    got2 = counts()
    for g in (got, got2):
        check(g == {k: want[k] for k in g},
              f"heev 2stage N={N_EIG}: launches {g}, want {want}")
    kw_total += got["kw"] + got2["kw"]
    kt_total += got["kt"] + got2["kt"]
    steps_total += got["kw_steps"] + got2["kw_steps"]
    k1_by["sheev_2stage"] = got["k1"] + got2["k1"]
    H = A.to_dense()
    ev_ms = time_ms(torch, lambda: torch.linalg.eigvalsh(H), reps=1)
    ref = torch.linalg.eigvalsh(H.double())
    rel = float((w.double() - ref).abs().max() / ref.abs().max())
    eps = torch.finfo(f32).eps
    check(rel < 60 * eps * N_EIG,
          f"heev 2stage N={N_EIG}: spectrum {rel:.3e} off eigvalsh")
    log(f"[sheev] 2stage N={N_EIG} nb={NB_EIG}: {two:.3f} s (launches "
        f"{got}), torch.linalg.eigvalsh {ev_ms:.1f} ms; spectrum "
        f"{rel:.3e} off the f64 solver's (relative to the largest)")
    rec["heev_2stage"] = {"s": two, "launches": got, "eigvalsh_ms": ev_ms,
                          "rel": rel}
    del H
    # the chain's stages at 8192: one heev 2stage and one sgesvd, each
    # stage by CUDA events and the host clock
    G = generators.plrnt(N_EIG, N_EIG, NB_EIG, NB_EIG, seed=3873)
    rec["stages"] = {}
    for algo, M_ in (("heev2", A), ("gesvd", G)):
        prebuild_schedules(band, "gesvd" if algo == "gesvd" else "hetrd",
                           N_EIG, N_EIG, NB_EIG)
        rec["stages"][algo], g = eig_stage_times(
            torch, pk, sbr, tridiag, band, eig, algo, M_)
        want_s = eig_wants(torch, band, algo, N_EIG, N_EIG, NB_EIG, f32)
        check(g == {k: want_s[k] for k in g},
              f"{algo} stage run N={N_EIG}: launches {g}, want {want_s}")
        kw_total += g["kw"]
        kt_total += g["kt"]
        steps_total += g["kw_steps"]
        k1_by[f"s{algo}_stages"] = g["k1"]
    del G
    torch.cuda.empty_cache()
    # heev 2stage's window products (every dimension at most the first
    # sweep's window; sgesvd's take the same code path on 512-wide padded
    # operands, their launches held by the drivers)
    V = 3 * NB_EIG + NB_EIG // 4
    k1_paths = {"sheev_2stage_windows": k1_path_sum(
        torch, pk, record, "sheev_2stage_windows",
        [p for p in prods if max(p[1:4]) <= V], 1650)}
    rec["k1_paths"] = {k: {kk: v for kk, v in t_.items() if kk != "rows"}
                       for k, t_ in k1_paths.items()}
    lap("heev 2stage and its K1 products")
    del A
    # the profile at N/4: at 8192 the profiler's post-processing of an
    # shetrd's ~60k launches took 130 s
    n_prof = N_EIG // 4
    Ap = generators.plghe(0.0, n_prof, NB_EIG, seed=3872)
    _profile(torch, record, "shetrd_eig_profile",
             f"N={n_prof} nb={NB_EIG}", lambda: eig.hetrd(Ap))
    del Ap
    torch.cuda.empty_cache()
    lap("the shetrd profile")

    # the Givens chase on band storage: hbrdt's route for a BandMatrix
    g = torch.Generator(device="cuda").manual_seed(1660)
    X = torch.randn(N_CHASE, N_CHASE, device="cuda", generator=g)
    X = torch.tril(torch.triu(X, -B_CHASE))
    X = X + X.T
    Bb = BandMatrix.from_dense(X, B_CHASE, B_CHASE)
    steps = band.herm_chase_schedule(N_CHASE, B_CHASE).shape[0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    d, e = eig.hbrdt(Bb, B_CHASE)
    torch.cuda.synchronize()
    chase_s = time.perf_counter() - t2
    T = (torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)).double()
    ref = torch.linalg.eigvalsh(X.double())
    rel = float((torch.linalg.eigvalsh(T) - ref).abs().max()
                / ref.abs().max())
    check(rel < 60 * eps * N_CHASE,
          f"Givens chase N={N_CHASE} b={B_CHASE}: spectrum {rel:.3e} off")
    log(f"[chase] hbrdt on a BandMatrix N={N_CHASE} b={B_CHASE} (the "
        f"band-storage Givens chase, {steps} rotations, plain torch): "
        f"{chase_s:.2f} s, {1e6 * chase_s / steps:.1f} us a rotation; "
        f"spectrum {rel:.3e} off the f64 solver's")
    rec["chase"] = {"n": N_CHASE, "b": B_CHASE, "rotations": steps,
                    "s": chase_s, "rel": rel}
    lap("the Givens chase")
    rec["kw_launches"] = kw_total
    rec["kw_steps"] = steps_total
    rec["kt_launches"] = kt_total
    rec["k1_by"] = {k: v for k, v in k1_by.items() if v}
    rec["k2_by"] = {k: v for k, v in k2_by.items() if v}
    record["eig"] = rec
    return rec, k1_paths



# ---------------------------------------------------------------------
# Phase 17: the out-of-HBM tiers, the GEMM dispatcher and the rest of
# the single-device catalogue
# ---------------------------------------------------------------------

N_LM_S, NB_LM = 32768, 512         # spotrf_lowmem, budget a quarter of A
N_LM_D = 16384                     # dpotrf_lowmem (native FP64)
N_LM_LU = 16384                    # sgetrf / sgeqrf_lowmem, 256 MiB
LM_LU_BUDGET = 256 * 2**20
N_STREAM, NB_STREAM = 16384, 512   # gemm_ex(algo="stream")
STREAM_INFO = {"DPLASMA:GEMM:GPU:B": 8, "DPLASMA:GEMM:GPU:C": 8,
               "DPLASMA:GEMM:GPU:D": 4}
N_DTD, NB_DTD, N_DTD_QR, N_DTD_UNTIED = 8192, 512, 4096, 2048
N_LAPACK, NB_LAPACK = 16384, 512
N_MG, NB_MG = 2048, 512
# card vs CPU for the closed forms that are not exact: the two devices'
# arccos, cos, sin and pow may differ by an ulp, which chebvand's
# cos(i·arccos p) multiplies by i < N_MG (i·u·pi at 4096: 7.7e-4 in f32,
# 1.4e-12 in f64)
MG_TOL = {"float32": 2e-3, "complex128": 1e-11}
# the pltmg types whose values come from the hash or from integers
MG_EXACT = ("random", "hadamard", "moler", "riemann", "minij", "invhess",
            "wilkinson", "foster", "wright", "circul", "hankel", "fiedler",
            "langou")


def lowmem_bytes(op, N, nb, cw, item):
    """(host -> device, device -> host) bytes of one lowmem call: the
    schedule's sums (ops/potrf.py, ops/lu.py, ops/qr.py)."""
    h2d = d2h = 0
    for s in range(0, N, nb):
        w = min(nb, N - s)
        if op == "potrf":
            h2d += (N - s) * (w + s)
            d2h += (N - s) * w
        elif op == "getrf":
            h2d += N * w + sum((N - j0) * (min(j0 + cw, s) - j0)
                               for j0 in range(0, s, cw))
            d2h += N * w
        else:
            h2d += N * w + (s // nb) * nb * nb + sum(
                N - j * nb for j in range(s // nb)) * nb
            d2h += N * w + w * w
    return h2d * item, d2h * item


def rec_panel_k1(m, n, base=8):
    """K1 products of one recursive LU panel (``panels._lu_rec``): one
    Schur product a level, K1's when its dimensions are all >= 256."""
    if n <= base:
        return 0
    h = n // 2
    return (rec_panel_k1(m, h, base) + int(min(m - h, h, n - h) >= 256)
            + rec_panel_k1(m - h, n - h, base))


def lowmem_k1(op, N, nb, cw, pallas=False):
    """(K1, K3) launches of one lowmem call, from the code: potrf one
    product a streamed chunk; getrf one a block apply (its rows below the
    block), under ``panel.kernel=pallas`` K3 on the panels its gate takes
    and the rec panel's products on the others; geqrf three an apply and
    one a panel (``larft``); each K1's when every dimension is >= 256."""
    from dplasma_tpu_torch.kernels.pallas_qr import eligible_shape
    k1 = k3 = 0

    def add(*dims):
        nonlocal k1
        k1 += int(min(dims) >= 256)

    for s in range(0, N, nb):
        w = min(nb, N - s)
        if op == "potrf":
            for j0 in range(0, s, cw):
                add(N - s, min(j0 + cw, s) - j0, w)
        elif op == "getrf":
            for j0 in range(0, s, cw):
                c = min(j0 + cw, s) - j0
                if N - j0 - c > 0:
                    add(N - j0 - c, c, w)
            if pallas and eligible_shape(N - s, w):
                k3 += 1
            elif pallas:
                k1 += rec_panel_k1(N - s, w)
        else:
            for j in range(s // nb):
                add(nb, N - j * nb, w)
                add(nb, nb, w)
                add(N - j * nb, nb, w)
            add(w, N - s, w)
    return k1, k3


def pinned_rates(torch, nbytes=2**30):
    """Bytes a second of one pinned ``Tensor.copy_`` each way (the host
    link's bound), and of the tiers' pitched 2-D copies (``hostlink``) of
    512- and 4096-wide column blocks of a 16384-wide f32 host matrix."""
    import numpy as np
    from dplasma_tpu_torch.kernels import hostlink
    h = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)
    d = torch.empty(nbytes // 4, dtype=torch.float32, device="cuda")
    h2d = time_ms(torch, lambda: d.copy_(h, non_blocking=True))
    d2h = time_ms(torch, lambda: h.copy_(d, non_blocking=True))
    out = {"h2d_GBps": nbytes / h2d / 1e6, "d2h_GBps": nbytes / d2h / 1e6}
    del d
    n = 16384
    H = hostlink.HostMatrix(np.zeros((n, n), np.float32),
                            torch.device("cuda"))
    for w in (512, 4096):
        def up(w=w):
            for c0 in range(0, n, w):
                H.upload(0, n, c0, c0 + w)
        ms = time_ms(torch, up)
        out[f"pitched_{w}_GBps"] = n * n * 4 / ms / 1e6
        blk = torch.zeros((n, w), device="cuda")

        def down(w=w, blk=blk):
            for c0 in range(0, n, w):
                H.download(blk, 0, c0)
            H.finish()
        ms = time_ms(torch, down)
        out[f"pitched_{w}_d2h_GBps"] = n * n * 4 / ms / 1e6
    del H
    log("[hostlink] pinned copy_ of 1 GiB: h2d {h2d_GBps:.2f} GB/s, d2h "
        "{d2h_GBps:.2f} GB/s; pitched 2-D blocks of a 16384-wide f32 "
        "matrix: 512 wide h2d {pitched_512_GBps:.2f} / d2h "
        "{pitched_512_d2h_GBps:.2f} GB/s, 4096 wide h2d "
        "{pitched_4096_GBps:.2f} / d2h {pitched_4096_d2h_GBps:.2f} "
        "GB/s".format(**out))
    return out


def lowmem_case(torch, pk, plu, tag, run, op, N, nb, cw, item, budget,
                rates, pallas=False):
    """One lowmem call on the card, every count zeroed just before and
    read just after: its time, the bytes each way against the schedule's
    sums, the achieved rate against the pinned copy's, the peak device
    memory against the budget, K1 / K3 launches against the derived
    counts. Returns (result, record, K1 products recorded, K3 panels
    recorded as host (input, packed, perm))."""
    from dplasma_tpu_torch.kernels import hostlink
    panels = []
    orig_k3 = plu.lu_panel

    def k3_recorder(a):
        out = orig_k3(a)
        panels.append((a.cpu(), out[0].cpu(), out[1].cpu()))
        return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hostlink.reset_stats()
    pk.reset_counts()
    plu.reset_counts()
    box = {}

    def timed():
        t0 = time.perf_counter()
        box["out"] = run()
        torch.cuda.synchronize()
        box["s"] = time.perf_counter() - t0

    plu.lu_panel = k3_recorder
    try:
        products = recorded_k1_products(torch, pk, timed)
    finally:
        plu.lu_panel = orig_k3
    peak = torch.cuda.max_memory_allocated() - base
    st = hostlink.STATS
    k1, k3 = pk.LAUNCHES, plu.LAUNCHES
    want_h2d, want_d2h = lowmem_bytes(op, N, nb, cw, item)
    want_k1, want_k3 = lowmem_k1(op, N, nb, cw, pallas)
    if item != 4:                        # K1 and K3 take f32 only
        want_k1 = want_k3 = 0
    s = box["s"]
    bound_s = max(st.h2d_bytes / (rates["h2d_GBps"] * 1e9),
                  st.d2h_bytes / (rates["d2h_GBps"] * 1e9))
    r = {"N": N, "nb": nb, "cw": cw, "budget": budget, "s": s,
         "h2d_bytes": st.h2d_bytes, "d2h_bytes": st.d2h_bytes,
         "h2d_copies": st.h2d_copies, "d2h_copies": st.d2h_copies,
         "largest_h2d": st.largest_h2d,
         "h2d_GBps": st.h2d_bytes / s / 1e9,
         "link_GBps": (st.h2d_bytes + st.d2h_bytes) / s / 1e9,
         "bound_s": bound_s, "peak_bytes": peak,
         "peak_over_budget": peak / budget, "k1": k1, "k3": k3,
         "k1_want": want_k1, "k3_want": want_k3,
         "swapped_rows": st.swapped_rows, "swap_s": st.swap_s,
         "setup_s": st.setup_s, "ffma": pk.FFMA_LAUNCHES}
    log(f"[{tag}] N={N} nb={nb} cw={cw} budget {budget / 2**20:.0f} MiB: "
        f"{s:.3f} s (of it {st.setup_s:.3f} s copying the input into "
        f"pinned memory); h2d {st.h2d_bytes / 1e9:.3f} GB (schedule "
        f"{want_h2d / 1e9:.3f}) in {st.h2d_copies} copies, d2h "
        f"{st.d2h_bytes / 1e9:.3f} GB ({want_d2h / 1e9:.3f}) in "
        f"{st.d2h_copies}; {r['h2d_GBps']:.2f} GB/s h2d over the call "
        f"against {rates['h2d_GBps']:.2f} pinned (bound {bound_s:.3f} s, "
        f"{100 * bound_s / s:.1f}% of the call); peak device memory "
        f"{peak / 2**20:.1f} MiB = {r['peak_over_budget']:.3f} x the "
        f"budget; K1 {k1} (derived {want_k1}) K3 {k3} ({want_k3})"
        + (f"; {st.swapped_rows} rows swapped on the host in "
           f"{st.swap_s:.3f} s ({1e3 * st.swap_s / (-(-N // nb)):.2f} ms a "
           f"panel)" if op == "getrf" else ""))
    check((st.h2d_bytes, st.d2h_bytes) == (want_h2d, want_d2h),
          f"{tag}: bytes {st.h2d_bytes}/{st.d2h_bytes} != the schedule's "
          f"{want_h2d}/{want_d2h}")
    check((k1, k3) == (want_k1, want_k3),
          f"{tag}: K1/K3 launches {k1}/{k3} != derived {want_k1}/{want_k3}")
    check(pk.FFMA_LAUNCHES == 0, f"{tag}: a K1 product took the FFMA kernel")
    return box["out"], r, products, panels


def phase_lowmem_catalogue(torch, pk, plu, record):
    """Phase 17: the out-of-HBM tiers streaming over pinned host memory,
    the GEMM dispatcher's streamed GEMM, the DTD drivers, the LAPACK-layout
    Cholesky, the pltmg catalogue, map_tiles and factor_info. Every count
    zeroed just before each call and read just after. Returns its record,
    the K1 path sums and the K1 / K3 launches by path."""
    import dataclasses

    import numpy as np
    from dplasma_tpu_torch import adtt
    from dplasma_tpu_torch.descriptors import TileDesc, TileMatrix
    from dplasma_tpu_torch.kernels import pallas_dd as pdd
    from dplasma_tpu_torch.ops import blas3, checks, gemm, generators, info
    from dplasma_tpu_torch.ops import lu, matgen, potrf, qr
    from dplasma_tpu_torch.ops import map as pmap
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    rec = {}
    k1_paths, k1_by, k3_by = {}, {}, {}
    t_phase = time.perf_counter()
    t0 = t_phase

    def lap(what):
        nonlocal t0
        now = time.perf_counter()
        log(f"[phase17] {what}: {now - t0:.1f} s")
        rec.setdefault("section_s", {})[what] = now - t0
        t0 = now

    def pinned(x):
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h

    rates = pinned_rates(torch)
    rec["rates"] = rates
    lap("host link rates")

    # 1-2. potrf_lowmem: f32 at 32768 (budget 1 GiB) and FP64 at 16384
    for tag, dt, N in (("spotrf_lowmem", torch.float32, N_LM_S),
                       ("dpotrf_lowmem", torch.float64, N_LM_D)):
        A = generators.plghe(float(N), N, NB_LM, seed=3872, dtype=dt)
        Ah = pinned(A.data)
        a = Ah.numpy()
        item = a.itemsize
        budget = a.nbytes // 4
        nb, cw = potrf.plan_potrf_lowmem(N, a.dtype, budget)
        cw = max(cw // nb * nb, nb)
        L, r, products, _ = lowmem_case(
            torch, pk, plu, tag, lambda: potrf.potrf_lowmem(
                a, budget_bytes=budget), "potrf", N, nb, cw, item, budget,
            rates)
        check(nb == NB_LM, f"{tag}: plan nb {nb}")
        Ld = TileMatrix(torch.from_numpy(L).cuda(), A.desc)
        del L, Ah, a
        res, ok = checks.check_potrf(A, Ld, "L")
        Lin = potrf.potrf(A, "L").data
        diff = float((Ld.data - Lin).abs().max() / Lin.abs().max())
        tol = N * checks._eps(dt)
        log(f"[{tag}] check_potrf {res:.3e}; max|L - L(in-core potrf, "
            f"nb={NB_LM})| / max|L| = {diff:.3e} (tol N*u = {tol:.2e})")
        check(ok and res < 60, f"{tag}: check_potrf {res:.3e}")
        check(diff <= tol, f"{tag}: {diff:.3e} off the in-core potrf")
        r.update(check_potrf=res, vs_incore=diff, incore_tol=tol)
        rec[tag] = r
        k1_by[tag] = r["k1"]
        if products:
            k1_paths[tag] = k1_path_sum(torch, pk, record, tag, products,
                                        1700)
        del A, Ld, Lin
        torch.cuda.empty_cache()
        lap(tag)

    # where a lowmem call's time goes: one spotrf_lowmem at N=16384 (its
    # budget a quarter of A) under torch.profiler
    A = generators.plghe(16384.0, 16384, NB_LM, seed=3872)
    Ah = pinned(A.data)
    a = Ah.numpy()
    _profile(torch, rec, "spotrf_lowmem_profile", "spotrf_lowmem N=16384",
             lambda: potrf.potrf_lowmem(a, budget_bytes=a.nbytes // 4))
    del A, Ah, a
    lap("the spotrf_lowmem profile")

    # 3. getrf_lowmem under panel.kernel=pallas, every K3 panel recorded
    N = N_LM_LU
    A = generators.plrnt(N, N, NB_LM, NB_LM, seed=3872)
    Ah = pinned(A.data)
    a = Ah.numpy()
    cw = LM_LU_BUDGET // (3 * N * 4) // NB_LM * NB_LM
    panel_s = []
    orig_panel = lu._panel_lu

    def timed_panel(col):
        # each panel's device time, fenced on the host: the tier syncs
        # once a panel anyway (its pivots go to the host)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = orig_panel(col)
        torch.cuda.synchronize()
        panel_s.append(time.perf_counter() - t2)
        return out

    lu._panel_lu = timed_panel
    try:
        with cfg.override_scope({"panel.kernel": "pallas"}):
            (LU, perm), r, products, panels = lowmem_case(
                torch, pk, plu, "sgetrf_lowmem", lambda: lu.getrf_lowmem(
                    a, nb=NB_LM, budget_bytes=LM_LU_BUDGET), "getrf", N,
                NB_LM, cw, 4, LM_LU_BUDGET, rates, pallas=True)
        pallas_panels = list(panel_s)
        panel_s.clear()
        # the same call on the vendor panels (panel.kernel's default)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lu.getrf_lowmem(a, nb=NB_LM, budget_bytes=LM_LU_BUDGET)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t1
    finally:
        lu._panel_lu = orig_panel
    k3n = r["k3_want"]
    log(f"[sgetrf_lowmem] panels (host clock, fenced): {sum(pallas_panels):.3f}"
        f" s of the call; the {len(pallas_panels) - k3n} rec panels "
        f"{sum(pallas_panels[:-k3n]):.3f} s, the {k3n} K3 panels "
        f"{sum(pallas_panels[-k3n:]):.3f} s; the same call on cuSOLVER's "
        f"panels (panel.kernel=chain; CALU above lu.panel_chunk = "
        f"{cfg.mca_get_int('lu.panel_chunk', 8192)} rows): "
        f"{chain_s:.3f} s, its panels {sum(panel_s):.3f} s")
    check(perm.device.type == "cuda", "getrf_lowmem's perm is not on the card")
    worst = 0.0
    k3_rows = []
    for pa, ppacked, pperm in panels:
        pa = pa.cuda()
        want, wperm = plu.lu_panel_reference(pa)
        err = float((ppacked.cuda() - want).abs().max())
        check(torch.equal(pperm.cuda(), wperm) and err == 0.0,
              f"sgetrf_lowmem: a K3 panel {tuple(pa.shape)} differs from "
              f"lu_panel_reference ({err:.3e})")
        perm_eq, mabs, _, k_ms, p_ms, l_ms = k3_case(torch, plu, pa)
        check(perm_eq and mabs == 0.0, "K3 relaunch differs")
        b_ms, _ = lu_bound_ms(pa.shape[0], pa.shape[1])
        k3_rows.append({"M": pa.shape[0], "ms": k_ms, "plain_ms": p_ms,
                        "library_ms": l_ms, "bound_ms": b_ms})
        worst = max(worst, err)
    log(f"[sgetrf_lowmem] the {len(panels)} K3 panels bitwise equal to "
        f"lu_panel_reference (perm and factor); kernel "
        f"{sum(x['ms'] for x in k3_rows):.3f} ms, plain "
        f"{sum(x['plain_ms'] for x in k3_rows):.3f} ms, cuSOLVER "
        f"{sum(x['library_ms'] for x in k3_rows):.3f} ms over them")
    L = torch.tril(torch.from_numpy(LU).cuda(), -1)
    L.diagonal().fill_(1)
    U = torch.triu(torch.from_numpy(LU).cuda())
    del LU
    res = float((A.data[perm] - torch.matmul(L, U)).abs().max()
                / (A.data.abs().max() * N * checks._eps(torch.float32)))
    log(f"[sgetrf_lowmem] max|A[perm] - L U| / (max|A| N eps) = "
        f"{res:.3e} (the -x threshold 60)")
    check(res < 60, f"sgetrf_lowmem: residual {res:.3e}")
    r.update(residual=res, k3_panels=k3_rows, panels_s=pallas_panels,
             chain_s=chain_s, chain_panels_s=sum(panel_s))
    rec["sgetrf_lowmem"] = r
    k1_by["sgetrf_lowmem"], k3_by["sgetrf_lowmem"] = r["k1"], r["k3"]
    k1_paths["sgetrf_lowmem"] = k1_path_sum(torch, pk, record,
                                            "sgetrf_lowmem", products, 1710)
    del L, U, Ah, a, perm
    torch.cuda.empty_cache()
    lap("sgetrf_lowmem")

    # 4. geqrf_lowmem against check_qr, orthogonality and in-core geqrf
    Ah = pinned(A.data)
    a = Ah.numpy()
    (packed, Ts), r, products, _ = lowmem_case(
        torch, pk, plu, "sgeqrf_lowmem", lambda: qr.geqrf_lowmem(
            a, nb=NB_LM, budget_bytes=LM_LU_BUDGET), "geqrf", N, NB_LM,
        NB_LM, 4, LM_LU_BUDGET, rates)
    kt = N // NB_LM
    Af = TileMatrix(torch.from_numpy(packed).cuda(), A.desc)
    Tf = TileMatrix(torch.from_numpy(Ts).cuda(),
                    TileDesc(NB_LM, kt * NB_LM, NB_LM, NB_LM))
    del packed, Ts, Ah, a
    Q = qr.ungqr(Af, Tf).to_dense()
    R = torch.triu(Af.data)
    rq, okq = checks.check_qr(A, Q, R)
    ro, oko = checks.check_orthogonality(Q)
    del Q
    Ain, _ = qr.geqrf(A)
    Rin = torch.triu(Ain.data)
    diff = float((R - Rin).abs().max() / Rin.abs().max())
    tol = 1e-3
    log(f"[sgeqrf_lowmem] |A-QR| {rq:.3e}, |I-Q'Q| {ro:.3e}; max|R - "
        f"R(in-core geqrf, vendor panels)| / max|R| = {diff:.3e} (tol "
        f"{tol:g})")
    check(okq and oko, f"sgeqrf_lowmem: checks {rq:.3e} {ro:.3e}")
    check(diff <= tol, f"sgeqrf_lowmem: R {diff:.3e} off the in-core one")
    r.update(check_qr=rq, check_orthogonality=ro, vs_incore=diff)
    rec["sgeqrf_lowmem"] = r
    k1_by["sgeqrf_lowmem"] = r["k1"]
    k1_paths["sgeqrf_lowmem"] = k1_path_sum(torch, pk, record,
                                            "sgeqrf_lowmem", products, 1720)
    del A, Af, Tf, R, Ain, Rin
    torch.cuda.empty_cache()
    lap("sgeqrf_lowmem")

    # 5. gemm_stream through gemm_ex(algo="stream") beside blas3.gemm
    N = N_STREAM
    A = generators.plrnt(N, N, NB_STREAM, NB_STREAM, seed=1)
    B = generators.plrnt(N, N, NB_STREAM, NB_STREAM, seed=2)
    C = generators.plrnt(N, N, NB_STREAM, NB_STREAM, seed=3)
    inf = cfg.Info(STREAM_INFO)
    auto = gemm.plan_gemm(C, A, B)
    plan = gemm.plan_gemm(C, A, B, info=inf, algo="stream")
    nblk = (-(-N // (plan.b * NB_STREAM))) ** 2
    want = nblk * (-(-N // (plan.d * NB_STREAM)))
    pk.reset_counts()
    box = {}
    products = recorded_k1_products(torch, pk, lambda: box.setdefault(
        "out", gemm.gemm_ex(0.5, A, B, 2.0, C, info=inf, algo="stream")))
    launches = pk.LAUNCHES
    got = box.pop("out")
    ref = blas3.gemm(0.5, A, B, 2.0, C)
    rel = rel_fro(torch, got.data, ref.data)
    s_ms = time_ms(torch, lambda: gemm.gemm_ex(0.5, A, B, 2.0, C, info=inf,
                                               algo="stream"))
    d_ms = time_ms(torch, lambda: blas3.gemm(0.5, A, B, 2.0, C))
    b_ms, _ = gemm_bound_ms(N, N, N, 4, True, TF32_FLOPS / 3)
    log(f"[gemm_stream] M=N=K={N} mb=nb={NB_STREAM} plan {plan}: K1 "
        f"{launches} (derived {want}); rel_fro vs blas3.gemm {rel:.3e}; "
        f"{s_ms:.2f} ms beside blas3.gemm's one product {d_ms:.2f} ms "
        f"(3xTF32 bound {b_ms:.2f} ms); plan_gemm auto at this size on "
        f"{torch.cuda.get_device_name(0)} "
        f"({gemm.device_memory_bytes() / 2**30:.1f} GiB): {auto.algo}")
    check(launches == want, f"gemm_stream: K1 {launches} != {want}")
    check(rel <= TOL["float32"], f"gemm_stream: rel_fro {rel:.3e}")
    rec["sgemm_stream"] = {"plan": dataclasses.asdict(plan), "k1": launches,
                           "rel_fro": rel, "ms": s_ms, "dot_ms": d_ms,
                           "bound_ms": b_ms, "auto": auto.algo}
    k1_by["sgemm_stream"] = launches
    k1_paths["sgemm_stream"] = k1_path_sum(torch, pk, record,
                                           "sgemm_stream", products, 1730)
    del A, B, C, got, ref
    torch.cuda.empty_cache()
    lap("gemm_stream")

    # 6. the DTD drivers beside testing_spotrf
    nt = N_DTD // NB_DTD
    dtd_k1 = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
    kq = N_DTD_QR // NB_DTD
    ku = N_DTD_UNTIED // NB_DTD
    drv = {}
    for argv, k1_want in (
            (["testing_spotrf_dtd", "-N", str(N_DTD), "-t", str(NB_DTD),
              "-x"], dtd_k1),
            (["testing_dpotrf_dtd", "-N", str(N_DTD), "-t", str(NB_DTD),
              "-x"], 0),
            (["testing_sgemm_dtd", "-M", str(N_DTD), "-N", str(N_DTD),
              "-K", str(N_DTD), "-t", str(NB_DTD), "-x"], nt ** 3),
            (["testing_sgeqrf_dtd", "-N", str(N_DTD_QR), "-t", str(NB_DTD),
              "-x"], qr_k1_products(kq)),
            (["testing_sgetrf_incpiv_dtd", "-N", str(N_DTD_QR), "-t",
              str(NB_DTD), "-x"], incpiv_k1(kq)),
            (["testing_spotrf_dtd_untied", "-N", str(N_DTD_UNTIED), "-t",
              str(NB_DTD), "-x"],
             ku * (ku - 1) // 2 + ku * (ku - 1) * (ku - 2) // 6),
            (["testing_sgeqrf_dtd_untied", "-N", str(N_DTD_UNTIED), "-t",
              str(NB_DTD), "-x"], qr_k1_products(ku)),
            (["testing_spotrf", "-N", str(N_DTD), "-t", str(NB_DTD)],
             2 * nt - 3)):
        r = blas3_driver(torch, pk, pdd, argv, {}, k1_want, 0)
        drv[argv[0]] = r
        k1_by[f"{argv[0][8:]}_{argv[argv.index('-N') + 1]}"] = \
            r["k1_launches_run"]
    log(f"[dtd] testing_spotrf_dtd {drv['testing_spotrf_dtd']['best_s']:.4f}"
        f" s ({nt * (nt + 1) * (nt + 2) // 6} tasks) beside testing_spotrf "
        f"{drv['testing_spotrf']['best_s']:.4f} s at N={N_DTD} nb={NB_DTD}")
    rec["dtd"] = drv
    lap("the DTD drivers")

    # 7. potrf_lapack on a Fortran-ordered f32 host buffer (A is exactly
    # symmetric: the row-major host copy, transposed, is its column-major
    # buffer)
    N = N_LAPACK
    A = generators.plghe(float(N), N, NB_LAPACK, seed=3872)
    a = A.data.cpu().numpy().T
    check(a.flags.f_contiguous, "potrf_lapack: the buffer is not F-ordered")
    pk.reset_counts()
    t1 = time.perf_counter()
    inf_ = adtt.potrf_lapack(adtt.LapackView(a), NB_LAPACK)
    torch.cuda.synchronize()
    lap_s = time.perf_counter() - t1
    k1 = pk.LAUNCHES
    kt = N // NB_LAPACK
    back = torch.from_numpy(a).cuda()
    untouched = bool(torch.equal(torch.triu(back, 1),
                                 torch.triu(A.data, 1)))
    Ld = TileMatrix(torch.tril(back).contiguous(), A.desc)
    del back
    res, ok = checks.check_potrf(A, Ld, "L")
    bad = generators.plghe(0.0, N, NB_LAPACK, seed=3872).data.cpu().numpy().T
    info_bad = adtt.potrf_lapack(adtt.LapackView(bad), NB_LAPACK)
    log(f"[potrf_lapack] N={N} nb={NB_LAPACK} Fortran-ordered f32: INFO "
        f"{inf_}, {lap_s:.3f} s, K1 {k1} (derived {kt * (kt - 1) // 2}), "
        f"check_potrf {res:.3e}, strict upper untouched {untouched}; "
        f"plghe with bump 0 (not SPD): INFO {info_bad}")
    check(inf_ == 0 and ok and untouched, "potrf_lapack: INFO, check or "
          "the untouched upper triangle")
    check(k1 == kt * (kt - 1) // 2, f"potrf_lapack: K1 {k1}")
    check(info_bad > 0, f"potrf_lapack: INFO {info_bad} on a non-SPD matrix")
    rec["potrf_lapack"] = {"N": N, "info": inf_, "s": lap_s, "k1": k1,
                           "check_potrf": res, "info_non_spd": info_bad}
    k1_by["spotrf_lapack"] = k1
    del A, a, Ld, bad
    torch.cuda.empty_cache()
    lap("potrf_lapack")

    # 8. pltmg: every type and latms, card against the port on the CPU
    mg = {}
    slowest = (0.0, None)
    for dt in (torch.float32, torch.complex128):
        key = str(dt).split(".")[1]
        for name in matgen.TYPES:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = matgen.pltmg(name, N_MG, N_MG, NB_MG, NB_MG, dtype=dt)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1)
            want = matgen.pltmg(name, N_MG, N_MG, NB_MG, NB_MG, dtype=dt,
                                device="cpu")
            g = got.data.cpu()
            equal = bool(torch.equal(g, want.data))
            err = float((g - want.data).abs().max()
                        / max(float(want.data.abs().max()), 1.0))
            check(bool(torch.isfinite(got.data).all()),
                  f"pltmg {name} {key}: not finite")
            if name in MG_EXACT:
                check(equal, f"pltmg {name} {key}: not bitwise the CPU's")
            else:
                check(err <= MG_TOL[key], f"pltmg {name} {key}: {err:.3e}")
            mg[f"{name}_{key}"] = {"ms": ms, "bitwise": equal, "err": err}
            slowest = max(slowest, (ms, f"{name} {key}"))
        sv = np.geomspace(1.0, 1e-3, N_MG)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = matgen.latms(N_MG, N_MG, NB_MG, NB_MG, sv, dtype=dt)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1)
        want = matgen.latms(N_MG, N_MG, NB_MG, NB_MG, sv, dtype=dt,
                            device="cpu")
        s_ = torch.linalg.svdvals(got.data).double().cpu()
        sv_err = float((s_ - torch.from_numpy(sv)).abs().max())
        err = float((got.data.cpu() - want.data).abs().max()
                    / float(want.data.abs().max()))
        sv_tol = 1e-3 if dt == torch.float32 else 1e-10
        log(f"[pltmg] latms {key}: {ms:.1f} ms; its singular values "
            f"within {sv_err:.3e} of sv (tol {sv_tol:g} x max sv); "
            f"entrywise {err:.3e} off the CPU's (QRs on two libraries, "
            f"logged)")
        check(sv_err <= sv_tol, f"latms {key}: singular values {sv_err:.3e}")
        mg[f"latms_{key}"] = {"ms": ms, "sv_err": sv_err, "err": err}
        slowest = max(slowest, (ms, f"latms {key}"))
    rows = sorted(mg.items(), key=lambda kv: -kv[1]["ms"])
    log(f"[pltmg] {len(matgen.TYPES)} types + latms at {N_MG}x{N_MG} "
        f"nb={NB_MG} in s and z on the card: bitwise the CPU's "
        f"{sum(v.get('bitwise', False) for v in mg.values())} of "
        f"{2 * len(matgen.TYPES)} (gated on the {len(MG_EXACT)} "
        f"hash/integer types), the rest within {MG_TOL}; slowest "
        f"{slowest[1]} {slowest[0]:.1f} ms; then " + ", ".join(
            f"{k} {v['ms']:.1f}" for k, v in rows[1:6]))
    rec["pltmg"] = mg
    lap("pltmg")

    # 9. map_tiles and factor_info on the spotrf factor at 8192
    F = potrf.potrf(generators.plghe(float(N_DTD), N_DTD, NB_DTD,
                                     seed=3872), "L")

    def op(i, j, t):
        return t * 2.0 + (i - 2 * j)

    got = pmap.map_tiles(F, op)
    ok_map = all(torch.equal(got.tile(i, j), F.tile(i, j) * 2.0 + (i - 2 * j))
                 for i in range(F.MT) for j in range(F.NT))
    i0 = int(info.factor_info(F, "L"))
    G = potrf.potrf(generators.plghe(0.0, N_DTD, NB_DTD, seed=3872), "L")
    x = torch.tril(G.to_dense())
    bad_rows = torch.nonzero((~torch.isfinite(x)).any(dim=1))
    want_bad = int(bad_rows[0]) + 1 if bad_rows.numel() else 0
    i1 = int(info.factor_info(G, "L"))
    log(f"[map/info] map_tiles over the {F.MT}x{F.NT} tiles of the spotrf "
        f"factor at {N_DTD}: equal to the tile loop {ok_map}; factor_info "
        f"{i0} on it, {i1} on the factor of plghe with bump 0 (first bad "
        f"row {want_bad})")
    check(ok_map and i0 == 0 and i1 == want_bad and i1 > 0,
          "map_tiles / factor_info")
    rec["map_info"] = {"map_equal": ok_map, "info_spd": i0,
                       "info_non_spd": i1}
    del F, G, x, got
    torch.cuda.empty_cache()
    lap("map_tiles and factor_info")
    rec["wall_s"] = time.perf_counter() - t_phase
    record["phase17"] = rec
    return rec, k1_paths, k1_by, k3_by


# ---------------------------------------------------------------------
# Phase 18: the rest of the block-cyclic catalogue on the 2x2 virtual mesh
# ---------------------------------------------------------------------

# SUMMA, the solves, BLAS-3, inverses and QR at the ptgpanel's size (so
# geqrf_cyclic's K5 broadcast is phase 2's bcast_getrf shape)
N_QC, NB_QC = N_GT, NB_GT
# geqrf_cyclic factors an N_QC x N_QC_COLS matrix: its CholeskyQR2 panels
# square each panel's condition, and a square f32 matrix's last panel
# (nb x nb random rows) takes a Gram past 1/u (tools/cyclic_qr_envelope.py;
# ROADMAP queue 3); the tall matrix's panels keep >= N_QC - N_QC_COLS rows
N_QC_COLS = N_QC // 2
N_TC = 2048                # every trsm corner, held by its residual
# heev_cyclic / gesvd_cyclic against the single-device port's values:
# max|Δ| / max|value| (Weyl: both reductions' backward errors, a few
# sqrt(N)·u ||A|| each, bound the distance; 1e-4 leaves ~18x at 8192)
CYC_TOL = 1e-4


def cyclic_k1_counts(op, n, nb, lookahead=1):
    """K1 launches of one call of ``op`` on GRID, f32, every slab
    dimension >= 256, derived from parallel/cyclic.py and ops/gemm.py:
    one product a step and rank for the sweeps (two for her2k; two TRSM
    sweeps for potrs and getrs; trtri + lauum for potri), lcm(P, Q)·2
    SUMMA steps a rank (MCA gemm.summa_steps = 2), and for the
    CholeskyQR2 panels two Gram products a rank plus R2·R1 and the
    reconstruction's LU once an axis group: geqrf five a rank and step
    (+ two at lookahead), herbt ten, ge2gb five a half-step (the shapes
    of each call are recorded through the wrapper and timed by
    ``k1_path_sum``, as the products of cyclic_k1_products are)."""
    P, Q = GRID
    R, kt = P * Q, n // nb
    grp = 1 + nopiv_k1(nb)
    return {
        "potrf_U": R * kt, "trsm": R * kt, "potrs": 2 * R * kt,
        "getrs": 2 * R * kt, "gemm_cyclic": R * kt,
        "gemm_ex_summa": R * (P * Q // math.gcd(P, Q)) * 2,
        "herk": R * kt, "trmm": R * kt, "hemm": R * kt, "her2k": 2 * R * kt,
        "lauum": R * kt, "trtri": R * kt, "potri": 2 * R * kt,
        "geqrf": kt * (5 * R + Q * grp) + lookahead * (kt - 1) * 2 * R,
        "herbt": (kt - 1) * (10 * R + Q * grp),
        "ge2gb": kt * (5 * R + Q * grp) + (kt - 1) * (5 * R + P * grp),
    }[op]


def phase_cyclic_catalogue(torch, pk, pring, record):
    """Phase 18: the rest of the block-cyclic catalogue on the 2x2
    virtual mesh in f32 with K1 on — potrf_cyclic U and potrs L / U at
    the spotrf ladder's size, getrs after getrf_cyclic, trsm (one corner
    timed, all six held by residual), gemm_cyclic and gemm_ex's SUMMA,
    herk, trmm, hemm, her2k, lauum, trtri, potri, geqrf_cyclic on the K5
    ring with qr_t_factor + unmqr, heev_cyclic and gesvd_cyclic. Each op
    once warm, then timed by CUDA events (the best of two), every kernel
    count zeroed just before the first timed call and read just after
    it; the single-device port op on the same inputs timed beside it and
    the reference's check run on the result. Returns (its record, the K1
    path sums, K1 launches by path, K5 broadcasts of the geqrf call, its
    KW launches, KW steps and KT launches)."""
    from dplasma_tpu_torch.descriptors import Dist, TileMatrix
    from dplasma_tpu_torch.kernels import sbr, tridiag
    from dplasma_tpu_torch.ops import band
    from dplasma_tpu_torch.ops import blas3, checks, eig, gemm, generators
    from dplasma_tpu_torch.ops import lu, potrf, qr
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.utils import config as cfg

    pk.enable(True)
    P, Q = GRID
    dist = Dist(P=P, Q=Q)
    f32 = torch.float32
    rec = {"ops": {}}
    k1_paths, k1_by, cache = {}, {}, {}
    eig_counts = {"kw": 0, "kw_steps": 0, "kt": 0}
    t_phase = time.perf_counter()
    t0 = t_phase

    def lap(what):
        nonlocal t0
        now = time.perf_counter()
        log(f"[phase18] {what}: {now - t0:.1f} s")
        rec.setdefault("section_s", {})[what] = now - t0
        t0 = now

    def zero():
        for mod in (pk, pring, sbr, tridiag):
            mod.reset_counts()

    def counts():
        return {"k1": pk.LAUNCHES, "ffma": pk.FFMA_LAUNCHES,
                "k5_bcast": pring.BCAST_LAUNCHES,
                "k5_shift": pring.SHIFT_LAUNCHES, "kw": sbr.LAUNCHES,
                "kw_steps": sbr.STEPS, "kt": tridiag.LAUNCHES}

    def events_ms(fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    def run_op(tag, run, want, single=None, reps=2, seed=0, timed_k1=True,
               warm=True, single_warm=True):
        """One warm call (unless a call of the same shapes came just
        before: ``warm`` False), then ``reps`` timed calls (the best
        kept; the counts of the first, zeroed just before it); ``want``
        holds those counts (``k1`` at least); the single-device op
        likewise (``single_warm`` False where an earlier phase ran it at
        the same shapes);
        every distinct K1 product recorded through the wrapper, held to
        gemm_reference and timed (``timed_k1``)."""
        if warm:
            run()
            torch.cuda.synchronize()
        zero()
        out, best = events_ms(run)
        got = counts()
        for _ in range(reps - 1):
            best = min(best, events_ms(run)[1])
        check(got["ffma"] == 0, f"{tag}: {got['ffma']} K1 products took "
                                f"the FFMA kernel")
        check(all(got[k] == v for k, v in want.items()),
              f"{tag}: launches {got}, want {want}")
        s_ms = s_out = None
        if single is not None:
            if single_warm:
                single()
                torch.cuda.synchronize()
            s_out, s_ms = events_ms(single)
            for _ in range(reps - 1):
                s_ms = min(s_ms, events_ms(single)[1])
        if timed_k1:
            prods = recorded_k1_products(torch, pk, run)
            check(sum(p[-1] for p in prods) == want["k1"],
                  f"{tag}: {sum(p[-1] for p in prods)} K1 products "
                  f"recorded, want {want['k1']}")
            k1_paths[tag] = k1_path_sum(torch, pk, record, tag, prods, seed,
                                        cache)
        k1_by[tag] = got["k1"]
        rec["ops"][tag] = {"ms": best, "single_device_ms": s_ms,
                           "launches": got}
        return out, best, s_out, s_ms

    def note(tag, res, ok, what, extra=""):
        r = rec["ops"][tag]
        r.update(residual=float(res), check=what)
        sd = r["single_device_ms"]
        log(f"[cyclic] {tag}: {r['ms']:.3f} ms (single-device port op "
            f"{'n/a' if sd is None else f'{sd:.3f} ms'}); K1 "
            f"{r['launches']['k1']}; {what} {float(res):.3e}{extra}")
        check(ok, f"{tag}: {what} {float(res):.3e}")

    with mesh.use_grid(mesh.make_mesh(P, Q)):
        # 1. potrf_cyclic U and potrs L / U at the spotrf ladder's size
        A = generators.plghe(float(N_PC), N_PC, NB_PC, seed=3872)
        C = cyclic.CyclicMatrix.from_tile(A, dist)
        U, ms, _, _ = run_op("potrf_cyclic_U",
                             lambda: cyclic.potrf_cyclic(C, "U"),
                             {"k1": cyclic_k1_counts("potrf_U", N_PC,
                                                     NB_PC),
                              "k5_bcast": 0}, seed=1800)
        res, ok = checks.check_potrf(A, U.to_tile(), "U")
        spotrf = record.get("spotrf", {}).get("best_s")
        rec["ops"]["potrf_cyclic_U"]["single_device_ms"] = (
            None if spotrf is None else 1e3 * spotrf)
        note("potrf_cyclic_U", res, ok and res < 60, "POTRF residual",
             f" (the single-device time: spotrf's, phase 3; uplo=L: "
             f"{record.get('potrf_cyclic', {}).get('s')} s, phase 10)")
        L = cyclic.potrf_cyclic(C, "L")
        B = generators.plrnt(N_PC, NB_PC, NB_PC, NB_PC, seed=3873)
        Bc = cyclic.CyclicMatrix.from_tile(B, dist)
        for uplo, F in (("L", L), ("U", U)):
            Fs = potrf.potrf(A, uplo)
            X, *_ = run_op(
                f"potrs_cyclic_{uplo}",
                lambda F=F, uplo=uplo: cyclic.potrs_cyclic(F, Bc, uplo),
                {"k1": cyclic_k1_counts("potrs", N_PC, NB_PC)},
                single=lambda Fs=Fs, uplo=uplo: potrf.potrs(Fs, B, uplo),
                seed=1810)
            res, ok = checks.check_axmb(A, B, X.to_tile())
            note(f"potrs_cyclic_{uplo}", res, ok, "|b-Ax|")
            del Fs, X
        del A, C, U, L, B, Bc
        torch.cuda.empty_cache()
        lap("potrf_cyclic U, potrs L and U")

        # 2. getrf_cyclic -> getrs_cyclic at the ptgpanel size
        n, nb = N_QC, NB_QC
        G = generators.plrnt(n, n, nb, nb, seed=3872)
        Gc = cyclic.CyclicMatrix.from_tile(G, dist)
        B = generators.plrnt(n, nb, nb, nb, seed=3874)
        Bc = cyclic.CyclicMatrix.from_tile(B, dist)
        F, perm = cyclic.getrf_cyclic(Gc)
        LU1, p1 = lu.getrf_1d(G)
        X, *_ = run_op("getrs_cyclic",
                       lambda: cyclic.getrs_cyclic(F, perm, Bc),
                       {"k1": cyclic_k1_counts("getrs", n, nb)},
                       single=lambda: lu.getrs("N", LU1, p1, B), seed=1820)
        res, ok = checks.check_axmb(G, B, X.to_tile())
        note("getrs_cyclic", res, ok, "|b-Ax|")
        del F, perm, LU1, p1, X
        lap("getrs_cyclic")

        # 3. trsm_cyclic: (L, N) timed at 8192, every corner at 2048
        Ah = generators.plghe(float(n), n, nb, seed=3875)
        Ahc = cyclic.CyclicMatrix.from_tile(Ah, dist)
        Lc = cyclic.potrf_cyclic(Ahc, "L")
        Ls = potrf.potrf(Ah, "L")
        Lt = TileMatrix.from_dense(torch.tril(Lc.to_tile().to_dense()), nb, nb)
        X, *_ = run_op("trsm_cyclic_LN",
                       lambda: cyclic.trsm_cyclic(Lc, Bc, "N"),
                       {"k1": cyclic_k1_counts("trsm", n, nb)},
                       single=lambda: blas3.trsm(1.0, Ls, B, side="L",
                                                 uplo="L", trans="N"),
                       seed=1830)
        res, ok = checks.check_axmb(Lt, B, X.to_tile())
        note("trsm_cyclic_LN", res, ok, "|b-Ax|")
        A2 = generators.plghe(float(N_TC), N_TC, nb, seed=3876)
        A2c = cyclic.CyclicMatrix.from_tile(A2, dist)
        B2 = generators.plrnt(N_TC, nb, nb, nb, seed=3877)
        B2c = cyclic.CyclicMatrix.from_tile(B2, dist)
        corners = {}
        for uplo in ("L", "U"):
            T2 = cyclic.potrf_cyclic(A2c, uplo)
            Td = T2.to_tile().to_dense()
            Td = torch.tril(Td) if uplo == "L" else torch.triu(Td)
            for trans in ("N", "T", "C"):
                zero()
                X2 = cyclic.trsm_cyclic(T2, B2c, trans, uplo=uplo)
                torch.cuda.synchronize()
                got = counts()
                op = Td if trans == "N" else Td.T
                res, ok = checks.check_axmb(
                    TileMatrix.from_dense(op, nb, nb), B2, X2.to_tile())
                corners[uplo + trans] = {"residual": res, "k1": got["k1"]}
                check(ok and got["k1"] == cyclic_k1_counts("trsm", N_TC, nb)
                      and got["ffma"] == 0,
                      f"trsm_cyclic {uplo}{trans} at {N_TC}: residual "
                      f"{res:.3e}, K1 {got['k1']} ({got['ffma']} FFMA)")
        log(f"[cyclic] trsm_cyclic every (uplo, trans) corner at {N_TC} "
            f"nb={nb}: |b-Ax| " + ", ".join(
                f"{k} {v['residual']:.3e}" for k, v in corners.items())
            + f"; K1 {cyclic_k1_counts('trsm', N_TC, nb)} each")
        rec["trsm_corners"] = corners
        del A2, A2c, B2, B2c, T2, X2, X
        lap("trsm_cyclic")

        # 4. SUMMA: gemm_cyclic and gemm_ex under the grid, 8192^3
        G2 = generators.plrnt(n, n, nb, nb, seed=3878)
        G2c = cyclic.CyclicMatrix.from_tile(G2, dist)
        Z = TileMatrix.zeros(n, n, nb, nb, device=G.device)
        Cs = blas3.gemm(1.0, G, G2, 0.0, Z)
        Cc, *_ = run_op("gemm_cyclic", lambda: cyclic.gemm_cyclic(Gc, G2c),
                        {"k1": cyclic_k1_counts("gemm_cyclic", n, nb)},
                        single=lambda: blas3.gemm(1.0, G, G2, 0.0, Z),
                        seed=1840)
        res, ok = checks.check_gemm(Cs, Cc.to_tile())
        note("gemm_cyclic", res, ok, "check_gemm vs blas3.gemm")
        check(gemm.plan_gemm(Z, G, G2).algo == "summa",
              "gemm_ex under the grid does not plan SUMMA")
        Ce, *_ = run_op("gemm_ex_summa",
                        lambda: gemm.gemm_ex(1.0, G, G2, 0.0, Z),
                        {"k1": cyclic_k1_counts("gemm_ex_summa", n, nb)},
                        single=lambda: blas3.gemm(1.0, G, G2, 0.0, Z),
                        seed=1845)
        res, ok = checks.check_gemm(Cs, Ce)
        note("gemm_ex_summa", res, ok, "check_gemm vs blas3.gemm")
        del Cc, Ce, Cs
        lap("SUMMA")

        # 5. the Level-3 BLAS and the inverses on the slabs
        blas = (
            ("herk_cyclic", "herk", lambda: cyclic.herk_cyclic(Gc),
             lambda: blas3.herk(1.0, G, 0.0, Z, "L"), True),
            ("trmm_cyclic", "trmm", lambda: cyclic.trmm_cyclic(Lc, G2c),
             lambda: blas3.trmm(1.0, Ls, G2, side="L", uplo="L"), False),
            ("hemm_cyclic", "hemm", lambda: cyclic.hemm_cyclic(Ahc, G2c),
             lambda: blas3.hemm(1.0, Ah, G2, 0.0, Z), False),
            ("her2k_cyclic", "her2k", lambda: cyclic.her2k_cyclic(Gc, G2c),
             lambda: blas3.her2k(1.0, G, G2, 0.0, Z, "L"), True),
            ("lauum_cyclic", "lauum", lambda: cyclic.lauum_cyclic(Lc),
             lambda: potrf.lauum(Ls, "L"), True))
        for j, (tag, op, run, single, lower) in enumerate(blas):
            out, _, ref, _ = run_op(tag, run,
                                    {"k1": cyclic_k1_counts(op, n, nb)},
                                    single=single, seed=1850 + 10 * j)
            got = out.to_tile()
            if lower:
                ref = TileMatrix.from_dense(torch.tril(ref.to_dense()), nb,
                                            nb)
                got = TileMatrix.from_dense(torch.tril(got.to_dense()), nb,
                                            nb)
            res, ok = checks.check_gemm(ref, got)
            note(tag, res, ok, "check_gemm vs the single-device op")
            del out, ref, got
        Xi, *_ = run_op("trtri_cyclic", lambda: cyclic.trtri_cyclic(Lc),
                        {"k1": cyclic_k1_counts("trtri", n, nb)},
                        single=lambda: potrf.trtri(Ls, "L"), seed=1900)
        res, ok = checks.check_inverse(Lt, Xi.to_tile())
        note("trtri_cyclic", res, ok, "check_inverse")
        Pi, *_ = run_op("potri_cyclic", lambda: cyclic.potri_cyclic(Lc),
                        {"k1": cyclic_k1_counts("potri", n, nb)},
                        single=lambda: potrf.potri(Ls, "L"), seed=1910)
        res, ok = checks.check_inverse(Ah, Pi.to_tile(), uplo="L")
        note("potri_cyclic", res, ok, "check_inverse (POTRI)")
        del Xi, Pi, Ahc, Lc, Ls, Lt, Ah, G2, G2c, Z
        torch.cuda.empty_cache()
        lap("herk, trmm, hemm, her2k, lauum, trtri, potri")

        # 6. geqrf_cyclic on the K5 ring (an N_QC x N_QC_COLS matrix),
        # qr_t_factor + unmqr, the psum route against it, one profile
        nq = N_QC_COLS
        Gq = generators.plrnt(n, nq, nb, nb, seed=3879)
        Gqc = cyclic.CyclicMatrix.from_tile(Gq, dist)
        check(cyclic._cyclic_ring(Gqc.desc, Gqc.dtype, mesh.active()),
              "ring.enable=auto does not resolve to the ring on this card")
        want_b, _ = ring_counts()["geqrf"]
        (Fq, Ts), *_ = run_op(
            "geqrf_cyclic", lambda: cyclic.geqrf_cyclic(Gqc),
            {"k1": cyclic_k1_counts("geqrf", nq, nb), "k5_bcast": want_b,
             "k5_shift": 0},
            single=lambda: qr.geqrf(Gq), seed=1920)
        k5_qc = rec["ops"]["geqrf_cyclic"]["launches"]["k5_bcast"]
        packed = Fq.to_tile()
        Tf = cyclic.qr_t_factor(Ts, Gq)
        eye = TileMatrix.from_dense(torch.eye(n, device=Gq.device), nb, nb)
        Qd = qr.unmqr("L", "N", packed, Tf, eye).to_dense()
        res, ok = checks.check_qr(Gq, Qd, torch.triu(packed.to_dense()))
        ores, ook = checks.check_orthogonality(Qd)
        note("geqrf_cyclic", res, ok and ook, "|A-QR|",
             f", |I-Q'Q| {ores:.3e}; {n}x{nq}; K5 {k5_qc} broadcasts (KT·P "
             f"= {want_b})")
        rec["ops"]["geqrf_cyclic"].update(orthogonality=ores, M=n, N=nq)
        with cfg.override_scope({"ring.enable": "off"}):
            before = pring.LAUNCHES
            F0, T0 = cyclic.geqrf_cyclic(Gqc)
            torch.cuda.synchronize()
            check(pring.LAUNCHES == before, "ring.enable=off launched K5")
        same = torch.equal(T0, Ts) and all(
            torch.equal(a, b) for r0, r1 in zip(F0.data, Fq.data)
            for a, b in zip(r0, r1))
        log(f"[cyclic] geqrf_cyclic: ring route "
            f"{'torch.equal' if same else 'DIFFERS FROM'} the psum route "
            f"(factor and T stack)")
        check(same, "geqrf_cyclic: the ring route differs from the psum "
                    "route")
        rec["ops"]["geqrf_cyclic"]["ring_equals_psum"] = same
        del F0, T0, Fq, Ts, packed, Tf, eye, Qd
        del Gqc, Gq, Gc, G, B, Bc
        # the profile at half the size: its post-processing takes most
        # of the section, in proportion to the launches (phase 16 does
        # the same for its shetrd)
        Gp = cyclic.CyclicMatrix.from_tile(generators.plrnt(
            n // 2, nq // 2, nb, nb, seed=3879), dist)
        _profile(torch, rec, "geqrf_cyclic_profile",
                 f"{n // 2}x{nq // 2} nb={nb} grid {P}x{Q}",
                 lambda: cyclic.geqrf_cyclic(Gp))
        del Gp
        torch.cuda.empty_cache()
        lap("geqrf_cyclic")

        # 7-8. heev_cyclic and gesvd_cyclic at phase 16's size
        ne, nbe = N_EIG, NB_EIG
        for algo in ("heev", "gesvd"):
            if algo == "heev":
                M = generators.plghe(0.0, ne, nbe, seed=3872)
                stage, s_tag = "herbt", "herbt_cyclic"
                stage_run = cyclic.herbt_cyclic
                full = cyclic.heev_cyclic
                k1c, kw, steps = herm_chain_counts(band, ne, nbe, f32)
                want = {"k1": k1c, "kw": kw, "kw_steps": steps, "kt": 1}

                def single(M=M):
                    return eig.heev(M, method="2stage")
            else:
                M = generators.plrnt(ne, ne, nbe, nbe, seed=3873)
                stage, s_tag = "ge2gb", "ge2gb_cyclic"
                stage_run = cyclic.gebrd_ge2gb_cyclic
                full = cyclic.gesvd_cyclic
                want = {k: v for k, v in eig_wants(
                    torch, band, "gesvd", ne, ne, nbe, f32).items()
                    if k != "k2"}

                def single(M=M):
                    return eig.gesvd(M)
            prebuild_schedules(band, "hetrd" if algo == "heev" else algo,
                               ne, ne, nbe)
            Mc = cyclic.CyclicMatrix.from_tile(M, dist)
            k1s = cyclic_k1_counts(stage, ne, nbe)
            want = dict(want, k1=want["k1"] + k1s)
            tag = f"{algo}_cyclic"
            # the single-device op ran at these shapes in phase 16, and
            # the cyclic op's own calls warm its stage 1
            w, _, ws, _ = run_op(tag, lambda Mc=Mc, f=full: f(Mc), want,
                                 single=single, reps=1, timed_k1=False,
                                 single_warm=False)
            run_op(s_tag, lambda Mc=Mc, f=stage_run: f(Mc), {"k1": k1s},
                   reps=1, warm=False, seed=1930 if algo == "heev" else 1960)
            for k in ("kw", "kw_steps", "kt"):
                eig_counts[k] += rec["ops"][tag]["launches"][k]
            dist_ = float((w - ws).abs().max() / ws.abs().max())
            rec["ops"][tag].update(vs_single_device=dist_, tol=CYC_TOL)
            log(f"[cyclic] {tag} N={ne} nb={nbe}: {rec['ops'][tag]['ms']:.1f}"
                f" ms (its stage 1 {rec['ops'][s_tag]['ms']:.1f} ms; the "
                f"single-device {algo} "
                f"{rec['ops'][tag]['single_device_ms']:.1f} ms); launches "
                f"{rec['ops'][tag]['launches']}; values within {dist_:.3e} "
                f"x max of the single-device port's (tol {CYC_TOL:g})")
            check(bool(torch.isfinite(w).all()) and dist_ <= CYC_TOL,
                  f"{tag}: {dist_:.3e} off the single-device values")
            del M, Mc, w, ws
            torch.cuda.empty_cache()
            lap(tag)

    # 9. the comm model's bytes at the phase's shapes (logged, not timed)
    comm = {}
    for op, mm, nn, bb in (("potrf", N_PC, N_PC, NB_PC),
                           ("getrf", N_GT, N_GT, NB_GT),
                           ("geqrf", N_QC, N_QC_COLS, NB_QC),
                           ("gemm", N_QC, N_QC, NB_QC),
                           ("herbt", N_EIG, N_EIG, NB_EIG),
                           ("ge2gb", N_EIG, N_EIG, NB_EIG)):
        desc = cyclic.CyclicDesc(mm, nn, bb, bb, dist)
        for ring in (False, True):
            m_ = cyclic.spmd_comm_model(desc, op, 4, ring=ring)
            comm[f"{op}_{'ring' if ring else 'psum'}"] = m_
    log("[cyclic] spmd_comm_model wire bytes (f32, grid 2x2): " + ", ".join(
        f"{k} {v['bytes_total'] / 2**30:.3f} GiB" for k, v in comm.items()))
    rec["comm_model"] = comm
    rec["k1_paths"] = {k: {kk: v for kk, v in t_.items() if kk != "rows"}
                       for k, t_ in k1_paths.items()}
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase18] took {rec['wall_s']:.1f} s")
    record["phase18"] = rec
    return rec, k1_paths, k1_by, k5_qc, eig_counts


# phase 19: the drivers' instruments (--report --profile --phase-profile
# --peaks-file, the ring span and its probe) on the card
N_PEAK = 8192                 # one product of each type for the peaks
def phase19_drivers():
    """(tag, argv, MCA scope) of each driver phase 19 runs."""
    return (
        ("spotrf", ["testing_spotrf", "-N", str(N_MAIN), "-t",
                    str(NB_MAIN), "-x"], {}),
        ("sgetrf", ["testing_sgetrf", "-N", str(N_LU), "-t", str(NB_LU),
                    "-x"], {"panel.kernel": "pallas"}),
        ("sgeqrf", ["testing_sgeqrf", "-N", str(N_QR), "-t", str(NB_QR),
                    "-x"], {"panel.kernel": "pallas"}),
        ("dpotrf_dd", ["testing_dpotrf", "-N", str(N_DD), "-t", str(NB_DD),
                       "-x"], {"dd_gemm": "always"}),
        ("dpotrf", ["testing_dpotrf", "-N", str(N_DD), "-t", str(NB_DD),
                    "-x"], {}),
        ("dposv_ir", ["testing_dposv_ir", "-N", str(N_IR), "-t",
                      str(NB_IR_POSV), "-K", str(NRHS_IR), "-x"],
         {"ir.precision": "f32"}),
        ("sgetrf_ptgpanel", ["testing_sgetrf_ptgpanel", "-N", str(N_GT),
                             "-t", str(NB_GT), "-p", str(GRID[0]), "-q",
                             str(GRID[1]), "-x"], {"ring.enable": "on"}),
    )


#: a span above this share of its roofline bound means a priced count or
#: a peak is wrong (every expectation is a lower bound)
ACHIEVED_MAX = 1.05


def sweep_rows(KT, NT, la, d):
    """The (phase, count) rows of one ``ops._sweep.pipelined_sweep`` at
    KT panels over NT column blocks, lookahead ``la`` and far-flush
    aggregation ``d`` (1 without an ``agg_apply``), with the one
    ``assemble`` of ``assemble_sweep``: its control flow walked on
    counts alone (the CPU tests hold it to the port's ledger)."""
    rows = {}

    def add(name):
        rows[name] = rows.get(name, 0) + 1

    pending, ahead, far = 0, 0, NT

    def peel():
        nonlocal far
        far -= 1
        if pending:
            add("catchup")

    for _ in range(min(1 + la, NT)):
        peel()
        ahead += 1
    for kk in range(KT):
        ahead -= 1
        add("panel")
        pending += 1
        if ahead:
            add("lookahead")
        if pending >= d or kk == KT - 1:
            if far:
                add("far_flush")
            pending = 0
        while ahead < 1 + la and far > 0:
            peel()
            ahead += 1
    add("assemble")
    return rows


def potrf_rows(nt, la):
    """The (phase, count) rows of one left-looking ``ops.potrf.potrf``
    at nt block columns and lookahead ``la``."""
    rows = {"panel": nt, "assemble": 1}
    far = sum(1 for kk in range(nt) if la > 0 and kk - la > 0)
    look = sum(1 for kk in range(nt)
               if (max(kk - la, 0) if la > 0 else 0) < kk)
    if far:
        rows["far_flush"] = far
    if look:
        rows["lookahead"] = look
    return rows


def driver_rows(tag, la, agg, refine=None):
    """The rows each phase 19 driver's attributed pass must give."""
    if tag == "spotrf":
        return potrf_rows(N_MAIN // NB_MAIN, la)
    if tag == "dpotrf":
        return potrf_rows(N_DD // NB_DD, la)
    if tag == "dpotrf_dd":          # the limb route has no span, as in
        return {}                   # the reference (ops/potrf.py:71-79)
    if tag in ("sgetrf", "sgeqrf"):
        kt = N_LU // NB_LU if tag == "sgetrf" else N_QR // NB_QR
        rows = sweep_rows(kt, kt, la, agg if tag == "sgeqrf" else 1)
        rows["assemble"] += 1      # the pivot / T-factor stitching
        return rows
    if tag == "dposv_ir":
        rows = potrf_rows(N_IR // NB_IR_POSV, la)
        rows.update(factor=1, solve=1,
                    residual=len(refine["backward_errors"]))
        if refine["iterations"]:
            rows["correct"] = refine["iterations"]
        return rows
    return {"ring": 1}              # the cyclic factorizations


def probe_peaks(torch, pk):
    """The card's peaks with the reference's keys (roofline.resolve_peaks
    reads them), each the best of the CUDA-event times of a few calls."""
    from dplasma_tpu_torch.kernels import dd
    n = N_PEAK
    flops = 2.0 * n ** 3
    g = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    a = torch.randn(n, n, device="cuda", generator=g)
    b = torch.randn(n, n, device="cuda", generator=g)
    pk.enable(True)
    out["f32_highest_gflops"] = flops / time_ms(
        torch, lambda: pk.gemm(a, b)) / 1e6
    ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out["bf16_gflops"] = flops / time_ms(
        torch, lambda: torch.matmul(ah, bh)) / 1e6
    del ah, bh
    a8 = torch.randint(-127, 128, (n, n), dtype=torch.int8, device="cuda")
    b8 = torch.randint(-127, 128, (n, n), dtype=torch.int8,
                       device="cuda").T   # K-contiguous, as dd._imm wants
    out["int8_gops"] = flops / time_ms(
        torch, lambda: torch._int_mm(a8, b8)) / 1e6
    del a8, b8
    a64, b64 = a.double(), b.double()
    c64 = torch.zeros_like(a64)
    out["f64_gflops"] = flops / time_ms(
        torch, lambda: torch.addmm(c64, a64, b64)) / 1e6
    del a64, b64, c64
    nl = dd._plan(n, 53)[1]
    out["f64equiv_bound_gflops"] = out["int8_gops"] / (nl * (nl + 1) // 2)
    src = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    out["hbm_gbps"] = 2 * src.numel() * 4 / time_ms(
        torch, lambda: dst.copy_(src)) / 1e6
    # the virtual mesh's transfers between ranks are device copies
    out["ici_gbps"] = out["hbm_gbps"]
    del src, dst
    h = torch.empty(2 ** 28, dtype=torch.float32, pin_memory=True)
    d = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")
    out["host_gbps"] = h.numel() * 4 / time_ms(
        torch, lambda: d.copy_(h, non_blocking=True)) / 1e6
    del h, d
    one = torch.zeros(1, device="cuda")

    def launches():
        for _ in range(1000):
            one.add_(1.0)
    out["latency_us"] = time_ms(torch, launches) # 1000 launches: ms = us
    return out


def phase_instruments(torch, pk, plu, pqr, pdd, pring, record):
    """Phase 19: the drivers' instruments on the card. Probes the peaks,
    writes them as a peaks file, runs each phase19_drivers() entry once
    plain and once with --report --profile --phase-profile
    --peaks-file (counts zeroed just before each and read just after),
    and potrf_cyclic under phases.profiling(); checks the reports, the
    phase rows, coverage, every span's achieved fraction, the ring span
    with its K5 probe, the timed runs' launches against the plain run's,
    the K1 events of the spotrf --jaxtrace trace and the profiles."""
    from dplasma_tpu_torch import native
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.observability import comm, phases
    from dplasma_tpu_torch.observability import report as rep_mod
    from dplasma_tpu_torch.observability import roofline
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.ops._sweep import sweep_params
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.utils import config as cfg
    t_phase = time.perf_counter()
    scratch = os.path.join(HERE, "build", "phase19")
    os.makedirs(scratch, exist_ok=True)
    peaks = probe_peaks(torch, pk)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    peaks_path = os.path.join(scratch, "peaks.json")
    with open(peaks_path, "w") as f:
        json.dump({"peaks": peaks, "device": smi}, f, indent=1)
    log(f"[peaks] {smi}: " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in peaks.items()))
    pk.enable(True)
    la, agg = sweep_params()
    out = {"peaks": peaks, "device": smi, "drivers": {}}
    launches_by = {lab: 0 for lab, _ in common.KERNELS}
    launches_by.update(k5_bcast=0, k5_shift=0)
    for tag, argv, mca in phase19_drivers():
        res = {}
        for mode in ("plain", "flags"):
            extra = []
            if mode == "flags":
                extra = ["--report=" + os.path.join(scratch, tag + ".json"),
                         "--profile=" + os.path.join(scratch, tag + ".prof"),
                         "--phase-profile", "--peaks-file=" + peaks_path]
            with cfg.override_scope(mca):
                common.RUNS.clear()
                for _, mod in common.KERNELS:
                    mod.reset_counts()
                rc = main(argv + extra)
                torch.cuda.synchronize()
                counts = {lab: mod.LAUNCHES for lab, mod in common.KERNELS}
                counts.update(k5_bcast=pring.BCAST_LAUNCHES,
                              k5_shift=pring.SHIFT_LAUNCHES)
            check(rc == 0, f"[phase19] {tag} ({mode}) exited {rc}")
            run = common.RUNS[-1]
            check(run["checks"] and all(c["ok"] for c in run["checks"]),
                  f"[phase19] {tag} ({mode}): checks {run['checks']}")
            res[mode] = (run, counts)
        run, counts = res["flags"]
        plain_op, op = res["plain"][0]["ops"][0], run["ops"][0]
        for lab, _ in common.KERNELS:
            check(op[f"{lab}_launches"] == plain_op[f"{lab}_launches"],
                  f"[phase19] {tag}: {lab} launches per timed run "
                  f"{op[f'{lab}_launches']} with the flags, "
                  f"{plain_op[f'{lab}_launches']} without")
        for lab in launches_by:
            launches_by[lab] += counts[lab]
        doc = rep_mod.load_report(os.path.join(scratch, tag + ".json"))
        (rop,) = doc["ops"]
        ph = rop["phases"]
        check(ph is not None, f"[phase19] {tag}: phases is null")
        algo = common._algo_of(argv[0])
        if comm.OP_CLASS.get(algo) is not None:
            check(rop["comm"] is not None, f"[phase19] {tag}: comm is null")
        check(len(doc.get("roofline") or []) == 1
              and doc["roofline"][0]["expected_s"] > 0,
              f"[phase19] {tag}: no roofline entry")
        rows = {s["phase"]: s["count"] for s in ph["spans"]}
        want = driver_rows(tag, la, agg,
                           run["refine"][-1] if run["refine"] else None)
        check(rows == want, f"[phase19] {tag}: phase rows {rows}, want "
                            f"{want}")
        cov = ph["coverage"]
        check((0 < cov <= 1.05) if want else cov == 0.0,
              f"[phase19] {tag}: coverage {cov}")
        worst = max([s["achieved_frac"] or 0.0 for s in ph["spans"]]
                    + [doc["roofline"][0]["achieved_frac"] or 0.0])
        check(worst <= ACHIEVED_MAX, f"[phase19] {tag}: achieved fraction "
                                     f"{worst:.3f} > {ACHIEVED_MAX}")
        events, info = native.read_trace(os.path.join(scratch, tag + ".prof"))
        check(info.get("driver") == argv[0] and any(
            e[0].startswith("phase:") for e in events),
            f"[phase19] {tag}: profile without its spans")
        if tag == "sgetrf_ptgpanel":
            # warm-up + timed factorizations, then the attributed pass:
            # one factorization and the probe's KT·P broadcasts
            nfact = len(op["k5_launches"]) + 1
            per = plain_op["k5_launches"][0]
            probe = counts["k5"] - (nfact + 1) * per
            check(probe == (N_GT // NB_GT) * GRID[0],
                  f"[phase19] {tag}: the ring probe launched K5 {probe} "
                  f"times, want KT·P = {(N_GT // NB_GT) * GRID[0]}")
        log(f"[phase19] {tag}: best {op['best_s']:.5f} s with the flags, "
            f"{plain_op['best_s']:.5f} s without; attributed run "
            f"{ph['attributed_run_s']:.5f} s, coverage {cov:.3f}; roofline "
            f"{doc['roofline'][0]['bound']} expected "
            f"{doc['roofline'][0]['expected_s']:.5g} s achieved "
            f"{doc['roofline'][0]['achieved_frac']:.4f}")
        for s in ph["spans"]:
            log(f"[phase19]   {tag} {s['phase']:<10} n={s['count']:4d} "
                f"measured {s['measured_s']:.6f} s expected "
                f"{s['expected_s']:.6g} s bound {s['bound']:<7} achieved "
                f"{s['achieved_frac']:.4f}")
        out["drivers"][tag] = {
            "argv": argv, "mca": mca, "best_s": op["best_s"],
            "plain_best_s": plain_op["best_s"], "phases": ph,
            "roofline": doc["roofline"][0], "comm": rop["comm"],
            **{f"{lab}_launches": op[f"{lab}_launches"]
               for lab, _ in common.KERNELS}}

    # the --jaxtrace trace of spotrf holds K1's kernel events
    tag, argv, _ = phase19_drivers()[0]
    for _, mod in common.KERNELS:
        mod.reset_counts()
    common.RUNS.clear()
    rc = main(argv + ["--jaxtrace=" + os.path.join(scratch, "trace")])
    torch.cuda.synchronize()
    check(rc == 0, f"[phase19] {tag} --jaxtrace exited {rc}")
    for lab, mod in common.KERNELS:
        launches_by[lab] += mod.LAUNCHES
    timed_k1 = sum(common.RUNS[-1]["ops"][0]["k1_launches"])
    with open(os.path.join(scratch, "trace", "trace.json")) as f:
        trace = json.load(f)
    k1_events = sum(1 for e in trace.get("traceEvents", [])
                    if "k1_gemm" in str(e.get("name", "")))
    # CUPTI may miss a kernel right after the profiler starts (a run of
    # this phase traced 28 of the 29): the trace must hold K1's events,
    # never more than the traced run launched
    check(0 < k1_events <= timed_k1,
          f"[phase19] the spotrf torch trace holds {k1_events} K1 events "
          f"for the {timed_k1} K1 launches of the traced run")
    log(f"[phase19] spotrf --jaxtrace: {k1_events} K1 kernel events in "
        f"the torch.profiler trace of its timed run ({timed_k1} K1 "
        f"launches)")

    # potrf_cyclic under a ledger: the ring span once, K5 KT·P inside it
    P, Q = GRID
    A = generators.plghe(float(N_PC), N_PC, NB_PC, seed=3872)
    with mesh.use_grid(mesh.make_mesh(P, Q)), \
            cfg.override_scope({"ring.enable": "on"}):
        C = cyclic.CyclicMatrix.from_tile(A, Dist(P=P, Q=Q))
        cyclic.potrf_cyclic(C)
        torch.cuda.synchronize()
        pring.reset_counts()
        cyclic.potrf_cyclic(C)
        torch.cuda.synchronize()
        k5_plain = pring.BCAST_LAUNCHES
        pring.reset_counts()
        t0 = time.perf_counter()
        with phases.profiling() as led:
            cyclic.potrf_cyclic(C)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5_all = pring.BCAST_LAUNCHES
    launches_by["k5"] += k5_all
    launches_by["k5_bcast"] += k5_all
    rows = {r["phase"]: r for r in led.summary()}
    kt = N_PC // NB_PC
    check(set(rows) == {"ring"} and rows["ring"]["count"] == 1,
          f"[phase19] potrf_cyclic: ledger rows {led.summary()}")
    check(k5_all - k5_plain == kt * P,
          f"[phase19] potrf_cyclic: the ring probe launched K5 "
          f"{k5_all - k5_plain} times, want KT·P = {kt * P}")
    model = roofline.phase_model("potrf", N_PC, N_PC, NB_PC, 4,
                                 grid=(P, Q))
    (ring,) = roofline.attribute_phases(
        led, model, roofline.resolve_peaks(peaks_path, "s")[0])
    check(ring["achieved_frac"] <= ACHIEVED_MAX,
          f"[phase19] potrf_cyclic: ring achieved {ring['achieved_frac']}")
    log(f"[phase19] potrf_cyclic N={N_PC} nb={NB_PC} grid {P}x{Q} ring on: "
        f"the ring span measured {ring['measured_s']:.6f} s (of {wall:.4f} s "
        f"for the call), expected {ring['expected_s']:.6g} s bound "
        f"{ring['bound']} achieved {ring['achieved_frac']:.4f}; K5 "
        f"{k5_all} = {k5_plain} (the factorization) + {k5_all - k5_plain} "
        f"(the probe, KT·P = {kt * P})")
    out["potrf_cyclic"] = {"ring": ring, "k5_factorization": k5_plain,
                           "k5_probe": k5_all - k5_plain, "call_s": wall}
    out["launches_by_kernel"] = launches_by
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[phase19] took {out['seconds']:.1f} s")
    record["instruments"] = out
    return launches_by


# phase 20: the live and measured instruments (--devprof --telemetry,
# the provenance stamp) on the card
def phase20_drivers():
    """(tag, argv, MCA scope) of phase 20's drivers: phase 19's spotrf
    and sgetrf_ptgpanel."""
    return tuple(d for d in phase19_drivers()
                 if d[0] in ("spotrf", "sgetrf_ptgpanel"))


#: a device timeline of the best run holds at most the run's time,
#: with this slack for the profiler's clock alignment
COVERAGE_MAX = 1.02
#: torch captures of spotrf's factorization late in the process, and
#: the timed runs in each (the capture's edges, phase 20)
EDGE_CAPTURES = 8
EDGE_RUNS = 3


def phase_live_instruments(torch, pk, pring, record, peaks_path):
    """Phase 20: ``--devprof`` and ``--telemetry`` on the card, with
    the provenance stamp of every ``--report`` (module docstring)."""
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.observability import report as rep_mod
    from dplasma_tpu_torch.observability import devprof as dp_mod
    from dplasma_tpu_torch.observability import telemetry
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    from dplasma_tpu_torch.utils import config as cfg
    t_phase = time.perf_counter()
    # a checkout with its own .git knows its commit; a copy does not
    commit_known = os.path.isdir(os.path.join(HERE, ".git"))
    scratch = os.path.join(HERE, "build", "phase20")
    os.makedirs(scratch, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    pk.enable(True)
    out = {"device": smi, "drivers": {}}
    launches_by = {lab: 0 for lab, _ in common.KERNELS}
    launches_by.update(k5_bcast=0, k5_shift=0)

    def drive(tag, argv, mca, mode):
        extra, mca = [], dict(mca)
        if mode != "plain":
            mca["devprof.backend"] = mode
            extra = ["--devprof",
                     f"--telemetry={scratch}/{tag}_{mode}.prom",
                     f"--report={scratch}/{tag}_{mode}.json",
                     f"--peaks-file={peaks_path}"]
        with cfg.override_scope(mca):
            common.RUNS.clear()
            for _, mod in common.KERNELS:
                mod.reset_counts()
            rc = main(argv + extra)
            torch.cuda.synchronize()
            for lab, mod in common.KERNELS:
                launches_by[lab] += mod.LAUNCHES
            launches_by["k5_bcast"] += pring.BCAST_LAUNCHES
            launches_by["k5_shift"] += pring.SHIFT_LAUNCHES
        check(rc == 0, f"[phase20] {tag} ({mode}) exited {rc}")
        run = common.RUNS[-1]
        check(run["checks"] and all(c["ok"] for c in run["checks"]),
              f"[phase20] {tag} ({mode}): checks {run['checks']}")
        check(pk.FFMA_LAUNCHES == 0,
              f"[phase20] {tag} ({mode}): a K1 product took the FFMA kernel")
        return run["ops"][0]

    def events(rows, kernel):
        return sum(r["count"] for r in rows or () if kernel in r["name"])

    for tag, argv, mca in phase20_drivers():
        modes = ("plain", "torch") if tag == "spotrf" \
            else ("plain", "auto", "torch")
        ops = {mode: drive(tag, argv, mca, mode) for mode in modes}
        plain = ops["plain"]
        res = {"argv": argv, "mca": mca, "plain_best_s": plain["best_s"]}
        for mode in modes[1:]:
            op = ops[mode]
            for lab, _ in common.KERNELS:
                check(op[f"{lab}_launches"] == plain[f"{lab}_launches"],
                      f"[phase20] {tag} ({mode}): {lab} launches per timed "
                      f"run {op[f'{lab}_launches']} with the flags, "
                      f"{plain[f'{lab}_launches']} without")
            doc = rep_mod.load_report(f"{scratch}/{tag}_{mode}.json")
            (dp,) = doc["devprof"]
            best = op["runs_s"].index(op["best_s"])
            # the Prometheus file against the report's metrics
            fams = telemetry.parse_prometheus_text(
                open(f"{scratch}/{tag}_{mode}.prom").read())
            for m in doc["metrics"]:
                if m["type"] == "histogram":
                    want = [(m["name"] + "_count", m["count"]),
                            (m["name"] + "_sum", m["sum"])]
                else:
                    want = [(m["name"], m["value"])]
                for name, value in want:
                    got = [v for n, lab, v in fams[m["name"]]["samples"]
                           if n == name and lab == m["labels"]]
                    check(got == [value], f"[phase20] {tag} ({mode}): "
                          f"{name}{m['labels']} exported {got}, report "
                          f"{value}")
            tel = doc["telemetry"]
            kinds = [e["kind"] for e in tel["flight_recorder"]["events"]]
            check(kinds[:3] == ["run_start", "op_start", "op_done"],
                  f"[phase20] {tag} ({mode}): flight ring {kinds}")
            prov = doc["provenance"]
            check(prov["backend"] == "cuda" and prov["torch"]
                  and prov["cuda"] and prov["device_name"]
                  == torch.cuda.get_device_name(0),
                  f"[phase20] {tag} ({mode}): provenance {prov}")
            if commit_known:
                check((prov["git"] or {}).get("sha"),
                      f"[phase20] {tag} ({mode}): no commit in {prov}")
            cats = dp["categories"]
            rec = dp["reconciliation"]
            top = dp.get("device_ops") or []
            k1_ev, k5_ev = events(top, "k1_gemm"), events(top, "k5_ring_")
            if mode == "auto":
                check(dp["backend"] == "synthetic" and "virtual mesh"
                      in dp.get("note", ""),
                      f"[phase20] {tag} (auto): backend {dp['backend']}, "
                      f"note {dp.get('note')!r}")
            else:
                check(dp["backend"] == "torch",
                      f"[phase20] {tag} (torch): backend {dp['backend']}, "
                      f"note {dp.get('note')!r}: the capture recorded no "
                      f"device event")
                check(cats["compute"] > 0 and dp["coverage"]
                      <= COVERAGE_MAX, f"[phase20] {tag} (torch): compute "
                      f"{cats['compute']} s, coverage {dp['coverage']}")
                check(k1_ev == op["k1_launches"][best],
                      f"[phase20] {tag}: {k1_ev} K1 events in the best "
                      f"run's timeline, {op['k1_launches'][best]} K1 "
                      f"launches in that run; note {dp.get('note')!r}")
                if tag == "sgetrf_ptgpanel":
                    check(k5_ev == op["k5_launches"][best] > 0
                          and cats["ici"] > 0,
                          f"[phase20] {tag}: {k5_ev} K5 events, "
                          f"{op['k5_launches'][best]} K5 launches, ici "
                          f"{cats['ici']} s")
                    exp, ing = rec["expected"], rec["ingested"]
                    for cls in ("ring_bcast@q", "ring_shift@p"):
                        check(exp.get(cls) and ing.get(cls) == exp[cls],
                              f"[phase20] {tag}: {cls} ingested "
                              f"{ing.get(cls)}, expected {exp.get(cls)}")
            log(f"[phase20] {tag} devprof.backend={mode} -> {dp['backend']}:"
                f" best {op['best_s']:.5f} s with --devprof --telemetry, "
                f"{plain['best_s']:.5f} s without; coverage "
                f"{dp['coverage']:.4f}, relation {rec['relation']}; "
                + ", ".join(f"{c} {v:.6f} s" for c, v in cats.items())
                + (f"; note: {dp['note']}" if dp.get("note") else ""))
            for d in dp["diagnostics"]:
                log(f"[phase20]   {tag} ({mode}) diagnostic {d['kind']} "
                    f"{d['op']}: {d['message']}")
            for c in dp["collectives"]:
                log(f"[phase20]   {tag} ({mode}) {c['cls']:<14} n="
                    f"{c['count']} measured {c['measured_s']:.6f} s achieved "
                    f"{c['achieved_frac']}")
            for r in top[:8]:
                log(f"[phase20]   {tag} top op {r['category']:<10} "
                    f"n={r['count']:5d} {r['seconds'] * 1e3:9.3f} ms "
                    f"{r['name'][:90]}")
            if mode == modes[-1]:
                log(f"[phase20] {tag}: provenance git {prov['git']} (the "
                    f"checkout {'has' if commit_known else 'has no'} .git),"
                    f" torch "
                    f"{prov['torch']}, cuda {prov['cuda']}, backend "
                    f"{prov['backend']}, device {prov['device_name']}; "
                    f"{tel['exporter']['flushes']} snapshot(s); flight "
                    f"{kinds}; K1 events {k1_ev}, K5 events {k5_ev}")
            res[mode] = {"best_s": op["best_s"], "devprof": {
                k: dp.get(k) for k in ("backend", "note", "coverage",
                                       "categories", "reconciliation",
                                       "collectives", "skew", "ok")},
                "device_ops": top[:20], "k1_events": k1_ev,
                "k5_events": k5_ev,
                "k1_launches": op["k1_launches"],
                "k5_launches": op["k5_launches"],
                "provenance": prov, "flight": kinds}
        out["drivers"][tag] = res

    # the capture's edges late in the process: repeated torch captures
    # of spotrf's factorization, EDGE_RUNS timed runs each. Every run's
    # window must hold its K1 launches; the marker kernels at the edges
    # (DevprofCapture._pad: a fill, CAPTURE_MARKERS adds, and at the
    # head the sentinel) are counted: a lost one is a record the
    # profiler dropped at an edge
    card = torch.device("cuda")
    A = generators.plghe(float(N_MAIN), N_MAIN, NB_MAIN, seed=3872)
    potrf_mod.potrf(A, "L")
    torch.cuda.synchronize()
    edges = []
    want_edges = [dp_mod.CAPTURE_MARKERS + 2, dp_mod.CAPTURE_MARKERS + 1]
    for c in range(EDGE_CAPTURES):
        cap = dp_mod.DevprofCapture(backend="torch", device=card)
        launched = []
        with cap:
            for i in range(EDGE_RUNS):
                with cap.run(i):
                    torch.cuda.synchronize()
                    n0 = pk.LAUNCHES
                    potrf_mod.potrf(A, "L")
                    torch.cuda.synchronize()
                    launched.append(pk.LAUNCHES - n0)
        runs = [cap.select(i) for i in range(EDGE_RUNS)]
        k1 = [events(dp_mod.device_ops(ops), "k1_gemm") for ops in runs]
        every = cap.captured()
        first = min(o["begin_ns"] for o in runs[0]) if runs[0] else 0
        last = max(o["end_ns"] for o in runs[-1]) if runs[-1] else 0
        edge_ops = [sum(o["end_ns"] <= first for o in every),
                    sum(o["begin_ns"] >= last for o in every)]
        launches_by["k1"] += sum(launched)
        edges.append({"k1_events": k1, "k1_launches": launched,
                      "edge_ops": edge_ops})
        check(k1 == launched, f"[phase20] edge capture {c}: K1 events "
              f"{k1} per run, K1 launches {launched}; edge marker ops "
              f"held {edge_ops} of {want_edges} (start, end); note "
              f"{cap.note!r}")
    log(f"[phase20] {EDGE_CAPTURES} torch captures of {EDGE_RUNS} potrf "
        f"runs (N={N_MAIN}, nb={NB_MAIN}): every run's K1 events equal "
        f"its launches ({edges[0]['k1_launches'][0]} a run); edge marker "
        f"ops held (start, end) {[e['edge_ops'] for e in edges]} of "
        f"{want_edges} a capture")
    out["edge_captures"] = edges
    out["launches_by_kernel"] = launches_by
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[phase20] took {out['seconds']:.1f} s ({smi})")
    record["live_instruments"] = out
    return launches_by


# phase 21: the dd route under the process grid, the resilience layer
# and tracecat
N_DDC, NB_DDC = N_DD, NB_DD    # potrf_cyclic dd at dpotrf_f64equiv's size
NB_DDC_LU = 256                # the dd LU passes -x at nb=256 (PERF.md)
N_DDC_OPS, NB_DDC_OPS = 2048, 512   # the rest of the catalogue under dd
#: dd vs native f64 of the catalogue's ops at N=2048, max|Δ| /
#: max|native|: both are f64-accurate; the stage-1 reductions (herbt,
#: ge2gb) carry their panels' rounding through every later step
DDC_TOL = 1e-10
N_REJ, NB_REJ = 4096, 512      # the reject plan's spotrf
NRUNS_DDC = 3                  # potrf_cyclic dd: best of, after a warm-up

#: the block-cyclic catalogue under dd: name -> call(lib, M) on the
#: inputs ``M`` (the CyclicMatrix of each name, the LU factor F with its
#: perm, the TileMatrix Gt and its SUMMA ``summa``); ``lib`` is the
#: cyclic module of either package (tests/test_torch_cyclic_dd.py holds
#: the port to the reference with it)
DDC_OPS = {
    "potrf_L": lambda lib, M: lib.potrf_cyclic(M["A"], "L"),
    "potrf_U": lambda lib, M: lib.potrf_cyclic(M["U"], "U"),
    "trsm": lambda lib, M: lib.trsm_cyclic(M["T"], M["B"]),
    "potrs": lambda lib, M: lib.potrs_cyclic(M["L"], M["B"]),
    "laswp": lambda lib, M: lib.laswp_cyclic(M["B"], M["perm"]),
    "getrs": lambda lib, M: lib.getrs_cyclic(M["F"], M["perm"], M["B"]),
    "gemm_cyclic": lambda lib, M: lib.gemm_cyclic(M["G"], M["T"]),
    "gemm_ex": lambda lib, M: M["summa"](1.5, M["Gt"], M["Gt"], 0.5,
                                         M["Gt"]),
    "herk": lambda lib, M: lib.herk_cyclic(M["G"]),
    "trmm": lambda lib, M: lib.trmm_cyclic(M["T"], M["G"]),
    "hemm": lambda lib, M: lib.hemm_cyclic(M["A"], M["G"]),
    "her2k": lambda lib, M: lib.her2k_cyclic(M["G"], M["T"]),
    "lauum": lambda lib, M: lib.lauum_cyclic(M["L"]),
    "trtri": lambda lib, M: lib.trtri_cyclic(M["L"]),
    "potri": lambda lib, M: lib.potri_cyclic(M["L"]),
    "geqrf": lambda lib, M: lib.geqrf_cyclic(M["G"]),
    "herbt": lambda lib, M: lib.herbt_cyclic(M["A"]),
    "heev": lambda lib, M: lib.heev_cyclic(M["A"]),
    "ge2gb": lambda lib, M: lib.gebrd_ge2gb_cyclic(M["G"]),
    "gesvd": lambda lib, M: lib.gesvd_cyclic(M["G"]),
    "getrf": lambda lib, M: lib.getrf_cyclic(M["G"]),
}

#: the first --seed the derived plans are searched from (the drivers')
SEED0 = 3872


def flip_bits_above_floor(n):
    """Bits of an f32 ``L_jj`` whose flip moves ``A_jj = L_jj²`` past
    the ABFT probe's floor ``THRESHOLD·eps·N·max|A w|`` of spotrf's
    plghe matrix (N on the diagonal, |off-diagonal| <= 1/2, so
    max|A w| <= 1.5 N) for every ``L_jj`` the first tile can hold
    (sqrt(N - 1) to sqrt(N + 1/2), the power of two between included),
    and leave it in [1, 2^40]: finite, and the factor below it positive
    definite. Returns (bits, floor)."""
    import math
    import torch
    from dplasma_tpu_torch.ops.checks import THRESHOLD
    from dplasma_tpu_torch.resilience import inject
    floor = THRESHOLD * torch.finfo(torch.float32).eps * n * 1.5 * n
    lo, hi = math.sqrt(n - 1), math.sqrt(n + 0.5)
    vals = [float(v) for v in torch.linspace(lo, hi, 64)]
    p2 = 2.0 ** math.floor(math.log2(hi))
    if lo <= p2:
        vals += [p2, math.nextafter(p2, 0.0)]
    v = torch.tensor(vals, dtype=torch.float32)
    bits = []
    for bit in range(16, 32):
        f = inject._bitflip(v, bit).double()
        d = f * f - v.double() ** 2
        if bool((f.isfinite() & (f >= 1) & (f <= 2.0 ** 40)
                 & (d.abs() > floor)).all()):
            bits.append(bit)
    return bits, floor


def silent_flip_seed(n, nb):
    """The first --seed from SEED0 whose ``bitflip@potrf:1:1`` plan, in
    spotrf's first tile factor (nb, nb) of an N-row matrix, flips a
    diagonal entry at a bit of :func:`flip_bits_above_floor`: a finite,
    silent fault that the ABFT probe must flag. Returns (seed, index,
    bit)."""
    import itertools
    import torch
    from dplasma_tpu_torch.resilience import inject
    bits, _ = flip_bits_above_floor(n)
    for seed in itertools.count(SEED0):
        (i, j), bit = inject.bitflip_at(seed, "potrf", 0, (nb, nb),
                                        torch.float32)
        if i == j and bit in bits:
            return seed, (i, j), bit


def overflow_flip_seed(n, nb):
    """The first --seed from SEED0 whose ``bitflip@gemm:1:1`` plan flips
    bit 30, the top exponent bit, of an entry of spotrf's first
    trailing-update product (n, nb) above the border rows: every such
    product is below 2 in magnitude, so the flip multiplies it by
    2^128, and the factor built on it overflows. Returns (seed, index,
    bit)."""
    import itertools
    import torch
    from dplasma_tpu_torch.resilience import inject
    for seed in itertools.count(SEED0):
        (i, j), bit = inject.bitflip_at(seed, "gemm", 0, (n, nb),
                                        torch.float32)
        if bit == 30 and i < n - nb:
            return seed, (i, j), bit


def _resilience(path):
    with open(path) as f:
        return json.load(f)["resilience"]


def phase_dd_grid_resilience(torch, pk, pdd, dd, record):
    """Phase 21 (module docstring): (a) the dd route under the 2x2 grid,
    (b)-(d) the resilience layer on the card, (e) tracecat."""
    from dplasma_tpu_torch.descriptors import Dist, TileMatrix
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.ops import checks, gemm, generators
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.resilience import guard
    from dplasma_tpu_torch.tools import tracecat
    from dplasma_tpu_torch.utils import config as cfg

    P, Q = GRID
    scratch = os.path.join(HERE, "build", "phase21")
    os.makedirs(scratch, exist_ok=True)
    always = {"dd_gemm": "always"}
    la = cyclic._cyclic_lookahead()
    out = {"k2": {}, "k1": {}, "k2_paths": {}}
    res = {}
    sec = {}
    t_sec = time.perf_counter()

    def ev_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = fn()
        end.record()
        torch.cuda.synchronize()
        return r, start.elapsed_time(end)

    def best_ms(fn):
        """One warm-up, then the best of NRUNS_DDC calls."""
        fn()
        runs = [ev_ms(fn) for _ in range(NRUNS_DDC)]
        return runs[-1][0], min(t_ for _, t_ in runs)

    # (a1) potrf_cyclic (L), f64 under dd_gemm=always, N=8192 nb=512, 2x2
    kt = N_DDC // NB_DDC
    A = generators.plghe(float(N_DDC), N_DDC, NB_DDC, seed=3872,
                         dtype=torch.float64)
    m = mesh.make_mesh(P, Q)
    with mesh.use_grid(m):
        C = cyclic.CyclicMatrix.from_tile(A, Dist(P=P, Q=Q))
        _, native_ms = best_ms(lambda: cyclic.potrf_cyclic(C))
        with cfg.override_scope(always):
            # the warm-up records every limb product through the wrapper
            # (each distinct shape held bitwise on its own operands)
            seen = recorded_k2_products(torch, pdd,
                                        lambda: cyclic.potrf_cyclic(C))
            pdd.reset_counts()
            pk.reset_counts()
            runs_ms = []
            for _ in range(NRUNS_DDC):
                L, t_ = ev_ms(lambda: cyclic.potrf_cyclic(C))
                runs_ms.append(t_)
            best = min(runs_ms)
            k2, unfused, k1 = pdd.LAUNCHES, pdd.UNFUSED, pk.LAUNCHES
            single, single_ms = best_ms(lambda: potrf_mod.potrf(A, "L"))
    _, native1_ms = best_ms(lambda: potrf_mod.potrf(A, "L"))
    want = cyclic_k2_launches("potrf_L", P, Q, kt, la)
    Lt = L.to_tile()
    r_, ok = checks.check_potrf(A, Lt, "L")
    got_l = torch.tril(Lt.to_dense())
    want_l = torch.tril(single.to_dense())
    diff = float((got_l - want_l).abs().max() / want_l.abs().max())
    from dplasma_tpu_torch.utils import flops
    gfl = flops.potrf(N_DDC, False) / 1e9 / (best / 1e3)
    log(f"[potrf_cyclic_dd] N={N_DDC} nb={NB_DDC} grid {P}x{Q} dd_gemm="
        f"always: best of {NRUNS_DDC} after a warm-up {best:.3f} ms "
        f"(runs {[round(t_, 3) for t_ in runs_ms]}; {gfl:.1f} GFLOP/s "
        f"LAWN-41), K2 {k2} launches in {NRUNS_DDC} calls (want {want} a "
        f"call), unfused {unfused}, K1 {k1}; POTRF residual "
        f"{float(r_):.3e}; max|L - L_single_dd| / max|L| {diff:.3e}; on "
        f"this card, best of {NRUNS_DDC} after a warm-up: native FP64 "
        f"potrf_cyclic {native_ms:.3f} ms, "
        f"single-device dd potrf {single_ms:.3f} ms, native FP64 "
        f"potrf {native1_ms:.3f} ms")
    check(k2 == want * NRUNS_DDC and unfused == 0 and k1 == 0,
          f"potrf_cyclic dd: K2 {k2} in {NRUNS_DDC} calls (want {want} a "
          f"call), unfused {unfused}, K1 {k1}")
    check(bool(ok) and float(r_) < 60, f"potrf_cyclic dd: check_potrf "
                                       f"{float(r_)}")
    check(diff <= DD_TOL, f"potrf_cyclic dd vs single-device dd: {diff}")
    g = torch.Generator(device="cuda").manual_seed(21)
    out["k2_paths"]["potrf_cyclic_dd"] = k2_path_sum(
        torch, dd, pdd, g, "potrf_cyclic_dd", seen, N_DDC)
    out["k2"]["potrf_cyclic_dd"] = k2
    res["potrf_cyclic_dd"] = {
        "N": N_DDC, "nb": NB_DDC, "grid": [P, Q], "ms": best,
        "runs_ms": runs_ms, "gflops": gfl, "k2": k2,
        "k2_want_per_call": want, "residual": float(r_),
        "rel_diff_single_dd": diff,
        "native_potrf_cyclic_ms": native_ms, "single_dd_ms": single_ms,
        "native_single_ms": native1_ms}
    del C, L, Lt, single, got_l, want_l, A
    sec["potrf_cyclic_dd"] = time.perf_counter() - t_sec

    # (a2) testing_dgetrf_ptgpanel under dd, nb=256, beside native FP64
    t_sec = time.perf_counter()
    argv = ["testing_dgetrf_ptgpanel", "-N", str(N_DDC), "-t",
            str(NB_DDC_LU), "-p", str(P), "-q", str(Q), "-x"]
    want = cyclic_k2_launches("getrf", P, Q, N_DDC // NB_DDC_LU, la)
    ptg = dd_driver(torch, pdd, argv, always, 0, want, False)
    ptg_native = dd_driver(torch, pdd, argv, {}, 0, 0, False)
    out["k2"]["getrf_ptgpanel_dd"] = sum(ptg["k2_launches"])
    res["getrf_ptgpanel_dd"] = {"dd": ptg, "native": ptg_native,
                                "k2_want": want}
    sec["getrf_ptgpanel_dd"] = time.perf_counter() - t_sec

    # (a3) the rest of the catalogue under dd at N=2048, nb=512
    t_sec = time.perf_counter()
    n, nb = N_DDC_OPS, NB_DDC_OPS
    kt = n // nb
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(r, c):
        return torch.randn(r, c, generator=gen, device="cuda",
                           dtype=torch.float64)
    a0 = rnd(n, n)
    spd = a0 @ a0.T + n * torch.eye(n, device="cuda", dtype=torch.float64)
    dense = {"A": spd, "U": torch.triu(spd),
             "L": torch.linalg.cholesky(spd),
             "T": rnd(n, n) + 2 * n * torch.eye(n, device="cuda",
                                                dtype=torch.float64),
             "G": rnd(n, n), "B": rnd(n, nb)}
    rows = {}
    with mesh.use_grid(m):
        M = {k: cyclic.CyclicMatrix.from_tile(
            TileMatrix.from_dense(v, nb, nb), Dist(P=P, Q=Q))
            for k, v in dense.items()}
        M["F"], M["perm"] = cyclic.getrf_cyclic(M["G"])
        M["Gt"] = TileMatrix.from_dense(dense["G"], nb, nb)
        M["summa"] = gemm.gemm_ex
        for op, fn in DDC_OPS.items():
            if op in ("potrf_L", "getrf"):
                continue            # (a1) and (a2), at full size
            call = functools.partial(fn, cyclic, M)
            # one call each, no warm-up (K2 is built, the shapes are
            # the op's own): the times are first calls
            want_o, nat_ms = ev_ms(call)
            with cfg.override_scope(always):
                pdd.reset_counts()
                got_o, dd_ms = ev_ms(call)
                k2o, unf = pdd.LAUNCHES, pdd.UNFUSED
            err = 0.0
            for gt, wt in zip(guard._leaves(got_o), guard._leaves(want_o)):
                if gt.is_floating_point():
                    err = max(err, float((gt - wt).abs().max()
                                         / wt.abs().max().clamp_min(1e-300)))
                else:
                    check(torch.equal(gt, wt), f"{op} dd: integers differ")
            wk = cyclic_k2_launches(op, P, Q, kt, la, nb=nb)
            log(f"[cyclic_dd] {op:12s} N={n} nb={nb}: dd {dd_ms:9.3f} ms "
                f"native {nat_ms:9.3f} ms, max rel diff {err:.3e}, K2 "
                f"{k2o} (want {wk}), unfused {unf}")
            check(k2o == wk and unf == 0, f"{op} dd: K2 {k2o} (want {wk}),"
                                          f" unfused {unf}")
            check(err <= DDC_TOL, f"{op} dd vs native: {err:.3e}")
            rows[op] = {"dd_ms": dd_ms, "native_ms": nat_ms,
                        "rel_diff": err, "k2": k2o}
        del M
    out["k2"]["cyclic_dd_ops"] = sum(r["k2"] for r in rows.values())
    res["cyclic_dd_ops"] = {"N": n, "nb": nb, "ops": rows}
    del dense, spd, a0
    sec["cyclic_dd_ops"] = time.perf_counter() - t_sec

    # (b) testing_spotrf -N 16384 -t 1024 --abft under three bitflip
    # plans: the default seed's (logged), and two whose seeds are derived
    # from the fault's size against the ABFT floor (gated)
    t_sec = time.perf_counter()
    pk.enable(True)
    k1_primary = len(main_path_products(N_MAIN + NB_MAIN, NB_MAIN))
    bits, floor = flip_bits_above_floor(N_MAIN)
    o_seed, o_idx, o_bit = overflow_flip_seed(N_MAIN, NB_MAIN)
    s_seed, s_idx, s_bit = silent_flip_seed(N_MAIN, NB_MAIN)
    log(f"[spotrf_abft] ABFT probe floor at N={N_MAIN}: {floor:.1f} "
        f"(60·eps·N·1.5N); L_jj bits whose flip passes it and stays "
        f"finite: {bits}; derived seeds: gemm bit 30 --seed {o_seed} "
        f"{o_idx}, potrf diagonal --seed {s_seed} {s_idx} bit {s_bit}")
    cases = (("default", "gemm", SEED0, None),
             ("overflow", "gemm", o_seed, (o_idx, "numerical")),
             ("silent", "potrf", s_seed, (s_idx, "silent")))
    abft_runs = {}
    for key, stage, seed, want in cases:
        rep = os.path.join(scratch, f"spotrf_abft_{key}.json")
        common.RUNS.clear()
        rc = main(["testing_spotrf", "-N", str(N_MAIN), "-t", str(NB_MAIN),
                   "-x", "--abft", f"--inject=bitflip@{stage}:1:1",
                   "--seed", str(seed), f"--report={rep}", "-v"])
        torch.cuda.synchronize()
        run = common.RUNS[-1]
        op = run["ops"][0]
        r = _resilience(rep)[0]
        faults = r["injection"]["faults"]
        acts = [(a["action"], a["ok"], a["classification"],
                 bool((a["abft"] or {}).get("detected")))
                for a in r["attempts"]]
        log(f"[spotrf_abft] {key} bitflip@{stage} --seed {seed}: faults "
            f"{faults}, attempts {acts}, outcome {r['outcome']}, K1 per "
            f"attempt {[(a['action'], a['k1']) for a in op['attempts']]}, "
            f"best {op['best_s']:.5f} s, checks " + ", ".join(
                f"{c['check']}={c['residual']:.3e}" for c in run["checks"]))
        check(rc == 0 and all(c["ok"] for c in run["checks"]),
              f"spotrf --abft {key}: rc {rc}, {run['checks']}")
        check(op["attempts"][0]["k1"] == [k1_primary] * len(
            op["attempts"][0]["k1"]),
              f"spotrf --abft {key}: primary K1 {op['attempts'][0]['k1']} "
              f"(want {k1_primary} a run)")
        if want is not None:
            idx, cls = want
            check([tuple(f["index"]) for f in faults] == [idx]
                  and acts == [("primary", False, cls, True),
                               ("retry", True, None, False)]
                  and r["outcome"] == "remediated",
                  f"spotrf --abft {key}: fault {faults} (want {idx}), the "
                  f"ladder walked {acts} (want {cls}, flagged, healed on "
                  f"the retry)")
        abft_runs[key] = {"stage": stage, "seed": seed, "faults": faults,
                          "attempts": acts, "outcome": r["outcome"],
                          "best_s": op["best_s"],
                          "k1_per_attempt": [a["k1"]
                                             for a in op["attempts"]]}
        out["k1"][f"spotrf_abft_{key}"] = sum(
            sum(a["k1"]) for a in op["attempts"])
    res["spotrf_abft"] = dict(abft_runs, k1_primary_want=k1_primary,
                              floor=floor, bits=bits)
    sec["spotrf_abft"] = time.perf_counter() - t_sec

    # (c) testing_dpotrf -N 8192 -t 512 --abft under dd, no plan
    t_sec = time.perf_counter()
    rep = os.path.join(scratch, "dpotrf_dd_abft.json")
    k2_aug = len(dd_k2_shapes(N_DD + NB_DD, NB_DD))
    plain = dd_driver(torch, pdd, ["testing_dpotrf", "-N", str(N_DD), "-t",
                                   str(NB_DD)], always, 0,
                      len(dd_k2_shapes(N_DD, NB_DD)), False)
    ab = dd_driver(torch, pdd, ["testing_dpotrf", "-N", str(N_DD), "-t",
                                str(NB_DD), "-x", "--abft",
                                f"--report={rep}"], always, 0, k2_aug,
                   False)
    r = _resilience(rep)[0]
    log(f"[dpotrf_dd_abft] N={N_DD} nb={NB_DD} --abft, no plan: attempts "
        f"{[(a['action'], a['ok']) for a in r['attempts']]}, outcome "
        f"{r['outcome']}, faults detected {r['faults_detected']}; best "
        f"{ab['best_s']:.5f} s beside plain dd {plain['best_s']:.5f} s "
        f"(K2 per run {ab['k2_launches']} on the {N_DD + NB_DD}-row "
        f"bordered matrix, {plain['k2_launches']} plain)")
    check(len(r["attempts"]) == 1 and r["attempts"][0]["action"] ==
          "primary" and r["attempts"][0]["ok"] and r["outcome"] == "clean"
          and r["faults_detected"] == 0,
          f"dpotrf dd --abft took a rung on a clean run: {r}")
    out["k2"]["dpotrf_dd_abft"] = sum(ab["k2_launches"]) + sum(
        plain["k2_launches"])
    res["dpotrf_dd_abft"] = {"abft": ab, "plain": plain,
                             "outcome": r["outcome"]}
    sec["dpotrf_dd_abft"] = time.perf_counter() - t_sec

    # (d) a reject@potrf:1:1 plan walks to the kernel-fallback rung,
    # which the driver's close undoes; a K1 launch that fails under
    # --abft is no ladder class and fails the run
    t_sec = time.perf_counter()
    rep = os.path.join(scratch, "spotrf_reject.json")
    common.RUNS.clear()
    try:
        rc = main(["testing_spotrf", "-N", str(N_REJ), "-t", str(NB_REJ),
                   "-x", "--inject=reject@potrf:1:1", f"--report={rep}",
                   "-v"])
        torch.cuda.synchronize()
        after = (pk.enabled(), cfg.mca_snapshot().get("panel.kernel"))
    finally:
        pk.enable(True)
        cfg.mca_unset("panel.kernel")
    run = common.RUNS[-1]
    op = run["ops"][0]
    r = _resilience(rep)[0]
    acts = [(a["action"], a["ok"], a["classification"])
            for a in r["attempts"]]
    log(f"[spotrf_reject] N={N_REJ} nb={NB_REJ} reject@potrf:1:1: "
        f"attempts {acts}, outcome {r['outcome']}, winner {r['winner']}, "
        f"K1 per run of the surviving attempt {op['k1_launches']}; after "
        f"the driver closed: K1 enabled, panel.kernel = {after}")
    check(rc == 0 and all(c["ok"] for c in run["checks"]),
          f"spotrf reject: rc {rc}, {run['checks']}")
    check(acts == [("primary", False, "compile"),
                   ("kernel_fallback", True, None)]
          and r["outcome"] == "remediated"
          and [a["action"] for a in op["attempts"]] == ["kernel_fallback"]
          and not any(op["k1_launches"]) and after == (True, None),
          f"spotrf reject: the ladder walked {acts}, K1 "
          f"{op['k1_launches']}, after the close {after}")
    real_kernel = pk._kernel
    pk._kernel = lambda: (lambda args: 700)     # cudaErrorIllegalAddress
    try:
        main(["testing_spotrf", "-N", str(N_REJ), "-t", str(NB_REJ), "-x",
              "--abft"])
        err = None
    except RuntimeError as exc:
        err = str(exc)
    finally:
        pk._kernel = real_kernel
    log(f"[spotrf_k1_fails] --abft with K1's launch failing: raised "
        f"{err!r}; K1 enabled after {pk.enabled()}")
    check(err is not None and "launch failed: cudaError 700" in err
          and pk.enabled() and cfg.mca_get("panel.kernel") != "chain",
          f"spotrf --abft with a failing K1: raised {err!r}, K1 "
          f"{pk.enabled()}")
    res["spotrf_reject"] = {"attempts": acts, "outcome": r["outcome"],
                            "k1_failure_raised": err}
    sec["spotrf_reject"] = time.perf_counter() - t_sec

    # (e) tracecat on phase 19's DTPUPROF1 file
    t_sec = time.perf_counter()
    prof = os.path.join(HERE, "build", "phase19", "spotrf.prof")
    doc = tracecat.convert(prof)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    merged = tracecat.merge(
        [prof], phases=[os.path.join(HERE, "build", "phase19",
                                     "spotrf.json")])
    with open(os.path.join(scratch, "spotrf.trace.json"), "w") as f:
        json.dump(merged, f)
    phase_rows = [e for e in merged["traceEvents"]
                  if e["ph"] == "X" and e.get("cat") == "phase"]
    log(f"[tracecat] {prof}: {len(spans)} spans "
        f"({sorted({e['name'].split(':')[0] for e in spans})}), merged "
        f"with its report's phase table: {len(phase_rows)} phase rows")
    check(spans and any(e["name"].startswith("run[") for e in spans)
          and phase_rows, "tracecat: no run spans or phase rows")
    sec["tracecat"] = time.perf_counter() - t_sec

    log("[phase21] section seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sec.items()))
    record["phase21"] = dict(res, section_s=sec)
    return out


# ---------------------------------------------------------------------
# Phase 22: the serving layer
# ---------------------------------------------------------------------

NB_SV = 256                  # the serving tile (K1's gate: every product)
SV_BATCH = 16                # serving.max_batch; the replayed stacks
SV_K1_SIZES = (512, 1024, 2048)   # buckets whose K1 products are replayed
SV_K2_SIZES = (512, 1024)         # buckets whose IR residuals are replayed
SV_NRHS = 4
SV_REQ, SV_REQ_IR = 128, 32  # the f32 posv/gesv and f64 IR traffic
SV_N, SV_N_IR = (384, 2048), (512, 1024)
SV_SEED = 2222
SV_DEV = "cuda"              # a rehearsal on the CPU sets "cpu"
SV_TOL = {"float32": 1e-4, "float64": 1e-10}  # X vs the unbatched solve
SV_BENCH = ["--sizes", "384,640,1024,1536,2048", "--nb", str(NB_SV),
            "--max-batch", str(SV_BATCH), "--ops",
            "posv,gesv,posv_ir,gesv_ir", "--requests", "48", "--reps", "1",
            "--k1"]
SV_SOAK = ["--sizes", "384,640", "--nb", str(NB_SV), "--max-batch",
           str(SV_BATCH), "--ops", "posv,gesv", "--requests", "16",
           "--reps", "1", "--k1", "--soak", "--soak-seconds", "2",
           "--chaos", "nan@serving:0.3:2,delay@serving:0.2,off",
           "--mca", "serving.max_queue=12", "--mca", "chaos.delay_ms=2"]


def _sv_sync(torch):
    if SV_DEV == "cuda":
        torch.cuda.synchronize()


def serving_k1_want(op, n, nb, max_iters=10):
    """K1 launches of one batched dispatch at bucket ``n`` (f32 products,
    every one eligible at nb = 256): one element's count, the factor's
    2·nt − 3 products (lookahead 1) and two blocked trsm sweeps of
    nt − 1 products per solve (the right-hand side padded to a tile);
    the IR ops (f32 rung) solve max_iters + 1 times on the masked
    loop."""
    nt = -(-n // nb)
    if nt < 2:
        return 0
    solves = max_iters + 1 if op.endswith("_ir") else 1
    return 2 * nt - 3 + solves * 2 * (nt - 1)


def _strided_like(torch, spec, gen, kind):
    """A tensor of ``spec`` (shape, strides, dtype) with random contents
    in a buffer just large enough for the strides."""
    shape, stride, dtype = spec
    size = 1 + sum((s - 1) * st for s, st in zip(shape, stride) if s > 0)
    if kind == "digits":
        buf = torch.randint(-127, 128, (size,), generator=gen,
                            device=SV_DEV, dtype=torch.int8)
    elif kind == "scale":
        buf = torch.exp2(torch.randint(-6, 7, (size,), generator=gen,
                                       device=SV_DEV).double())
    else:
        buf = torch.randn(size, generator=gen, device=SV_DEV,
                          dtype=torch.float64).to(dtype)
    return buf.as_strided(shape, stride)


def _spec(x):
    return None if x is None else (tuple(x.shape), tuple(x.stride()),
                                   x.dtype)


def record_calls(mod, name, run, spec_of):
    """Run ``run()`` with ``mod.name`` wrapped; returns the run's result
    and {spec: count} of the calls it made."""
    seen = {}
    orig = getattr(mod, name)

    def rec(*args, **kw):
        key = spec_of(*args, **kw)
        seen[key] = seen.get(key, 0) + 1
        return orig(*args, **kw)

    setattr(mod, name, rec)
    try:
        out = run()
    finally:
        setattr(mod, name, orig)
    return out, seen


def batched_k1_case(torch, pk, label, spec, gen, count=1):
    """One batched K1 product replayed on random operands of the path's
    layout: every element ``torch.equal`` to its 2-D launch, the stack
    within the 2-D tolerance of the plain version; times of the batched
    launch, a loop of 2-D launches, the plain version, ``torch.bmm`` (or
    ``baddbmm``) and the bound."""
    (sa, sb, sc), (alpha, beta) = spec
    a = _strided_like(torch, sa, gen, "f")
    b = _strided_like(torch, sb, gen, "f")
    c = None if sc is None else _strided_like(torch, sc, gen, "f")
    B, M, K = a.shape
    N = b.shape[2]
    p = pk.plan_batched(M, N, K, a.dtype, a.stride(), b.stride(),
                        a.data_ptr(), b.data_ptr(),
                        pk._sms(a.device) if a.is_cuda else pk.H100_SMS)
    n0 = pk.BATCHED_LAUNCHES
    got = pk.gemm_batched(a, b, c, alpha=alpha, beta=beta)
    _sv_sync(torch)
    check(pk.BATCHED_LAUNCHES == n0 + 1, f"[k1b] {label}: not one launch")
    for i in range(B):
        one = pk.gemm(a[i], b[i], None if c is None else c[i], alpha=alpha,
                      beta=beta)
        check(torch.equal(got[i], one),
              f"[k1b] {label}: element {i} differs from its 2-D launch")
    ref = pk.gemm_batched_reference(a, b, c, alpha=alpha, beta=beta)
    mabs = (got.double() - ref.double()).abs().max().item()
    err = mabs / max(ref.double().abs().max().item(), 1e-30)
    check(err <= TOL[str(a.dtype).split(".")[-1]],
          f"[k1b] {label}: rel err {err:.3e} against the plain version")

    def loop():
        for i in range(B):
            pk.gemm(a[i], b[i], None if c is None else c[i], alpha=alpha,
                    beta=beta)

    def lib():
        if c is None:
            return torch.bmm(a, b) if alpha == 1.0 else alpha * torch.bmm(
                a, b)
        return torch.baddbmm(c, a, b, beta=beta, alpha=alpha)

    ms = time_ms(torch, lambda: pk.gemm_batched(a, b, c, alpha=alpha,
                                                beta=beta))
    loop_ms = time_ms(torch, loop)
    plain_ms = time_ms(torch, lambda: pk.gemm_batched_reference(
        a, b, c, alpha=alpha, beta=beta))
    lib_ms = time_ms(torch, lib)
    ops = 2.0 * B * M * N * K
    nbytes = a.element_size() * (
        (B if a.stride(0) else 1) * M * K + (B if b.stride(0) else 1) * K * N
        + B * M * N * (2 if c is not None else 1))
    peak = TF32_FLOPS / 3 if p.kernel == "wgmma" else FP32_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_S
    bound = 1e3 * max(t_ops, t_bytes)
    log(f"[k1b] {label}: ({B}x{M}x{K}) @ ({B}x{K}x{N}) {a.dtype} "
        f"c={'yes' if c is not None else 'no'} b_batch_stride={b.stride(0)}"
        f" plan {p.kernel} splits={p.splits} (x{count} a dispatch): batched"
        f" {ms:.4f} ms, 2-D loop {loop_ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" {'bmm' if c is None else 'baddbmm'} {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}"
        f"), rel err {err:.2e}; {B} elements torch.equal to 2-D launches")
    return {"label": label, "shape": [B, M, K, N], "kernel": p.kernel,
            "splits": p.splits, "count": count, "ms": ms, "loop_ms": loop_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": mabs, "rel_err": err}


def batched_k2_case(torch, pdd, label, spec, gen, count=1):
    """One batched K2 limb product replayed on random digits of the
    path's layout: bitwise to the plain batched version and every element
    to its 2-D launch; times of the batched launch, a loop of 2-D
    launches, the plain version and the int8 bound."""
    sal, sbl, sbase, ssa, ssb, w = spec
    al = _strided_like(torch, sal, gen, "digits")
    bl = _strided_like(torch, sbl, gen, "digits")
    base = None if sbase is None else _strided_like(torch, sbase, gen, "f")
    sa = None if ssa is None else _strided_like(torch, ssa, gen, "scale")
    sb = None if ssb is None else _strided_like(torch, ssb, gen, "scale")
    B, nl, M, K = al.shape
    N = bl.shape[2]
    n0 = pdd.BATCHED_LAUNCHES
    got = pdd.limb_product_base_batched(al, bl, base, sa, sb, w)
    _sv_sync(torch)
    check(pdd.BATCHED_LAUNCHES == n0 + 1, f"[k2b] {label}: not one launch")
    sae = None if sa is None else sa.expand(B, *sa.shape[1:])
    sbe = None if sb is None else sb.expand(B, *sb.shape[1:])
    ref = pdd.limb_product_base_batched_reference(al, bl, base, sae, sbe, w)
    check(torch.equal(got, ref),
          f"[k2b] {label}: not bitwise the plain version "
          f"(max {(got - ref).abs().max().item():.3e})")

    def one(i):
        return pdd.limb_product_base(
            al[i], bl[i], None if base is None else base[i],
            None if sa is None else sae[i], None if sb is None else sbe[i],
            w)

    for i in range(B):
        check(torch.equal(got[i], one(i)),
              f"[k2b] {label}: element {i} differs from its 2-D launch")

    def loop():
        for i in range(B):
            one(i)

    ms = time_ms(torch, lambda: pdd.limb_product_base_batched(
        al, bl, base, sa, sb, w))
    loop_ms = time_ms(torch, loop)
    plain_ms = time_ms(torch, lambda: pdd.limb_product_base_batched_reference(
        al, bl, base, sae, sbe, w), reps=1)
    ops = 2.0 * B * M * N * K * nl * (nl + 1) / 2
    nbytes = ((B if al.stride(0) else 1) * nl * M * K
              + (B if bl.stride(0) else 1) * nl * N * K
              + 8 * B * M * N * (2 if base is not None else 1)
              + 8 * B * (M + N))
    t_ops, t_bytes = ops / INT8_OPS, nbytes / HBM_BYTES_S
    bound = 1e3 * max(t_ops, t_bytes)
    log(f"[k2b] {label}: B={B} nl={nl} M={M} N={N} K={K} "
        f"(x{count} a dispatch): batched {ms:.4f} ms, 2-D loop "
        f"{loop_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}); bitwise to "
        f"the plain version and to {B} 2-D launches")
    return {"label": label, "shape": [B, nl, M, N, K], "count": count,
            "ms": ms, "loop_ms": loop_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": 0.0}


def _sv_operands(torch, gen, op, n, nrhs, dtype):
    """One request on the host, made on the card from ``gen``: SPD (G Gᵀ/n
    + I) for posv, G/√n + 2I for gesv (both well conditioned)."""
    g = torch.randn(n, n, generator=gen, device=SV_DEV, dtype=torch.float64)
    if op.startswith("posv"):
        a = g @ g.T / n + torch.eye(n, device=SV_DEV, dtype=torch.float64)
    else:
        a = g / math.sqrt(n) + 2 * torch.eye(n, device=SV_DEV,
                                             dtype=torch.float64)
    b = torch.randn(n, nrhs, generator=gen, device=SV_DEV,
                    dtype=torch.float64)
    return a.to(dtype).cpu().numpy(), b.to(dtype).cpu().numpy()


def serving_traffic(torch, pk, pdd, svc, reqs, solve_one, tag):
    """Submit ``reqs`` [(op, a, b)] as fast as they come, then flush and
    gather: every future resolves, passes the service's gate, and its X
    is within SV_TOL of the unbatched solve of the same request.
    Returns the counts of the window and the numbers."""
    import numpy as np
    pk.reset_counts()
    pdd.reset_counts()
    t0 = time.perf_counter()
    futs = [svc.submit(op, a, b) for op, a, b in reqs]
    svc.flush()
    xs = [f.result(600.0) for f in futs]
    _sv_sync(torch)
    wall = time.perf_counter() - t0
    counts = {"k1": pk.LAUNCHES, "k1_batched": pk.BATCHED_LAUNCHES,
              "k2": pdd.LAUNCHES, "k2_batched": pdd.BATCHED_LAUNCHES}
    worst = 0.0
    for (op, a, b), f, x in zip(reqs, futs, xs):
        check(f.meta.get("ok") and "resilience" not in f.meta,
              f"[{tag}] request {f.request_id} ({op} n={a.shape[0]}): "
              f"{f.meta}")
        if op.endswith("_ir"):
            check(f.meta["refine"]["converged"],
                  f"[{tag}] request {f.request_id} did not converge")
        u = solve_one(op, torch.from_numpy(a).to(SV_DEV),
                      torch.from_numpy(b).to(SV_DEV), NB_SV).cpu().numpy()
        err = float(np.abs(x - u).max() / max(np.abs(u).max(), 1e-30))
        worst = max(worst, err)
        check(err <= SV_TOL[a.dtype.name],
              f"[{tag}] request {f.request_id} ({op} n={a.shape[0]}): X "
              f"{err:.3e} from the unbatched solve")
    lats = sorted(f.meta["latency_s"] for f in futs)
    out = {"requests": len(reqs), "wall_s": wall,
           "solves_per_s": len(reqs) / wall,
           "p50_ms": 1e3 * lats[len(lats) // 2],
           "p99_ms": 1e3 * lats[min(len(lats) - 1,
                                    round(0.99 * (len(lats) - 1)))],
           "max_rel_vs_unbatched": worst, "launches": counts}
    return out


def dispatch_counts(torch, pk, pdd, svc, op, n, gen, dtype):
    """K1 and K2 launches of ONE full batched dispatch (SV_BATCH
    requests at bucket ``n``): a first full batch builds the cache entry
    (its build run launches the kernels too), then the counts are zeroed
    just before the second batch's last submit, which dispatches it, and
    read just after."""
    reqs = [(op, *_sv_operands(torch, gen, op, n, SV_NRHS, dtype))
            for _ in range(SV_BATCH)]
    for f in [svc.submit(o, a, b) for o, a, b in reqs]:
        f.result(600.0)
    futs = [svc.submit(o, a, b) for o, a, b in reqs[:-1]]
    pk.reset_counts()
    pdd.reset_counts()
    futs.append(svc.submit(*reqs[-1]))     # the 16th dispatches the batch
    svc.flush()
    for f in futs:
        f.result(600.0)
    _sv_sync(torch)
    got = {"k1": pk.LAUNCHES, "k1_batched": pk.BATCHED_LAUNCHES,
           "k2": pdd.LAUNCHES, "k2_batched": pdd.BATCHED_LAUNCHES}
    check(all(f.meta.get("batch") == SV_BATCH for f in futs),
          f"[sv-dispatch] {op} n={n}: not one batch of {SV_BATCH}")
    return got


def phase_serving(torch, pk, pdd, record):
    """Phase 22, the serving layer: the batched K1 and K2 forms on the
    serving shapes, SolverService at serving width, servebench."""
    import tempfile

    import numpy as np

    from dplasma_tpu_torch.kernels import pallas_kernels
    from dplasma_tpu_torch.resilience import inject
    from dplasma_tpu_torch.serving import SolverService, batched
    from dplasma_tpu_torch.tools import servebench
    from dplasma_tpu_torch.utils import config as cfg

    t_phase = time.perf_counter()
    secs = {}
    pk.enable(True)
    gen = torch.Generator(device=SV_DEV).manual_seed(SV_SEED)
    out = {"k1_cases": [], "k2_cases": []}

    # 1. batched K1: the products of one batched posv and gesv dispatch
    # at each bucket, recorded through the wrapper, replayed per layout
    t0 = time.perf_counter()

    def k1_spec(a, b, c=None, *, alpha=1.0, beta=1.0):
        return ((_spec(a), _spec(b), _spec(None if beta == 0.0 else c)),
                (float(alpha), float(beta)))

    for n in SV_K1_SIZES:
        for op in ("posv", "gesv"):
            A = torch.stack([torch.from_numpy(_sv_operands(
                torch, gen, op, n, SV_NRHS, torch.float32)[0]).to(SV_DEV)
                for _ in range(SV_BATCH)])
            Bs = torch.randn(SV_BATCH, n, SV_NRHS, generator=gen,
                             device=SV_DEV)
            pk.reset_counts()
            _, seen = record_calls(
                pallas_kernels, "gemm_batched",
                lambda: batched.solve_batched(op, A, Bs, NB_SV), k1_spec)
            want = serving_k1_want(op, n, NB_SV)
            check(pk.BATCHED_LAUNCHES == want == pk.LAUNCHES
                  == sum(seen.values()),
                  f"[k1b] {op} n={n}: {pk.BATCHED_LAUNCHES} batched of "
                  f"{pk.LAUNCHES} K1 launches (want {want})")
            # one replay per product shape and element layout (the batch
            # strides of the path's views differ, not the kernel's work)
            layouts = {}
            for spec, cnt in seen.items():
                (sa, sb, sc), ab = spec
                lay = (sa[0], sa[1][1:], sb[0], sb[1][1:], sc is None, ab)
                first, tot = layouts.get(lay, (spec, 0))
                layouts[lay] = (first, tot + cnt)
            for spec, cnt in layouts.values():
                (sa, sb, sc), _ = spec
                lab = (f"{op} n={n} {sa[0][1]}x{sa[0][2]}x{sb[0][2]}"
                       f"{' c' if sc else ''}")
                out["k1_cases"].append(batched_k1_case(
                    torch, pk, lab, spec, gen, cnt))
    # a broadcast operand (batch stride 0) and an FFMA case (a row stride
    # of 777 floats: no TMA)
    f32 = torch.float32
    out["k1_cases"].append(batched_k1_case(
        torch, pk, "broadcast B", (
            (((SV_BATCH, 512, 256), (512 * 256, 256, 1), f32),
             ((SV_BATCH, 256, 512), (0, 512, 1), f32), None), (1.0, 0.0)),
        gen))
    out["k1_cases"].append(batched_k1_case(
        torch, pk, "ffma ragged", (
            (((SV_BATCH, 300, 777), (300 * 777, 777, 1), f32),
             ((SV_BATCH, 777, 260), (777 * 260, 260, 1), f32),
             ((SV_BATCH, 300, 260), (300 * 260, 260, 1), f32)),
            (1.0, -1.0)), gen))
    check(out["k1_cases"][-1]["kernel"] == "ffma", "the FFMA case took "
          "the tensor cores")
    secs["k1"] = time.perf_counter() - t0

    # 2. batched K2: the residuals of one batched posv_ir / gesv_ir
    t0 = time.perf_counter()

    def k2_spec(al, bl, base, sa, sb, w):
        return (_spec(al), _spec(bl), _spec(base), _spec(sa), _spec(sb),
                int(w))

    with cfg.override_scope({"ir.precision": "f32"}):
        for n in SV_K2_SIZES:
            for op in ("posv_ir", "gesv_ir"):
                A = torch.stack([torch.from_numpy(_sv_operands(
                    torch, gen, op, n, SV_NRHS, torch.float64)[0]).to(SV_DEV)
                    for _ in range(SV_BATCH)])
                Bs = torch.randn(SV_BATCH, n, SV_NRHS, generator=gen,
                                 device=SV_DEV, dtype=torch.float64)
                pdd.reset_counts()
                (_, info), seen = record_calls(
                    pdd, "limb_product_base_batched",
                    lambda: batched.solve_batched(op, A, Bs, NB_SV),
                    k2_spec)
                check(bool(info["converged"].all()),
                      f"[k2b] {op} n={n}: not every element converged")
                want = 11
                check(pdd.BATCHED_LAUNCHES == want == pdd.LAUNCHES,
                      f"[k2b] {op} n={n}: {pdd.BATCHED_LAUNCHES} batched "
                      f"of {pdd.LAUNCHES} K2 launches (want {want})")
                for spec, cnt in seen.items():
                    out["k2_cases"].append(batched_k2_case(
                        torch, pdd, f"{op} n={n} residual", spec, gen, cnt))
    secs["k2"] = time.perf_counter() - t0

    # 3. SolverService at serving width
    t0 = time.perf_counter()
    rng = np.random.default_rng(SV_SEED)
    with cfg.override_scope({"ir.precision": "f32"}):
        svc = SolverService(nb=NB_SV, max_batch=SV_BATCH, device=SV_DEV)
        reqs = []
        for i in range(SV_REQ):
            op = ("posv", "gesv")[i % 2]
            n = int(rng.integers(SV_N[0], SV_N[1] + 1))
            nrhs = int(rng.integers(1, SV_NRHS + 1))
            reqs.append((op, *_sv_operands(torch, gen, op, n, nrhs,
                                           torch.float32)))
        reqs_ir = []
        for i in range(SV_REQ_IR):
            op = ("posv_ir", "gesv_ir")[i % 2]
            n = int(rng.integers(SV_N_IR[0], SV_N_IR[1] + 1))
            nrhs = int(rng.integers(1, SV_NRHS + 1))
            reqs_ir.append((op, *_sv_operands(torch, gen, op, n, nrhs,
                                              torch.float64)))
        gen_s = time.perf_counter() - t0
        cold = serving_traffic(torch, pk, pdd, svc, reqs,
                               servebench.solve_one, "sv-f32")
        cold_ir = serving_traffic(torch, pk, pdd, svc, reqs_ir,
                                  servebench.solve_one, "sv-ir")
        stats = svc.cache.stats()
        warm = serving_traffic(torch, pk, pdd, svc, reqs,
                               servebench.solve_one, "sv-f32-warm")
        per_dispatch = {}
        for op, dt in (("posv", torch.float32), ("gesv", torch.float32),
                       ("posv_ir", torch.float64),
                       ("gesv_ir", torch.float64)):
            n = 1024
            got = dispatch_counts(torch, pk, pdd, svc, op, n, gen, dt)
            want1 = serving_k1_want(op, n, NB_SV)
            want2 = 11 if op.endswith("_ir") else 0
            check(got["k1"] == got["k1_batched"] == want1
                  and got["k2"] == got["k2_batched"] == want2,
                  f"[sv-dispatch] {op} n={n}: {got} (want K1 {want1}, K2 "
                  f"{want2}, every launch batched)")
            per_dispatch[op] = dict(got, want_k1=want1, want_k2=want2)
            log(f"[sv-dispatch] {op} bucket n={n} batch {SV_BATCH}: K1 "
                f"{got['k1']} launches (one element's count {want1}), K2 "
                f"{got['k2']} (one a masked-loop residual: {want2})")
        # the per-request serving tap: the struck request heals on its
        # ladder, its batch-mates resolve from the batch
        reqs4 = [("posv", *_sv_operands(torch, gen, "posv", 1024, 2,
                                         torch.float32)) for _ in range(4)]
        inject.arm(inject.parse_plan("nan@serving:1:1"))
        try:
            futs = [svc.submit(*r) for r in reqs4]
            svc.flush()
            [f.result(600.0) for f in futs]
        finally:
            faults = inject.disarm()
        healed = [f for f in futs if "resilience" in f.meta]
        check(len(faults) == 1 and len(healed) == 1
              and healed[0].meta["resilience"]["outcome"] == "remediated"
              and healed[0].meta["resilience"]["winner"] == "posv"
              and all(f.meta.get("ok") for f in futs)
              and all(f.meta["batched"] and f.meta["batch"] == 4
                      for f in futs),
              f"[sv-inject] {[f.meta for f in futs]}")
        rung = [a["action"] for a in
                healed[0].meta["resilience"]["attempts"]]
        log(f"[sv-inject] nan@serving:1:1 struck request "
            f"{healed[0].request_id}: healed on rungs {rung}; "
            f"{len(futs) - 1} batch-mates resolved from the batch")
        summ = svc.summary()
        svc.close()
    secs["service"] = time.perf_counter() - t0
    out["service"] = {"f32_cold": cold, "ir_cold": cold_ir,
                      "f32_warm": warm, "cache_after_cold": stats,
                      "per_dispatch": per_dispatch, "summary": summ,
                      "generation_s": gen_s, "inject_rungs": rung}
    for tag, r in (("f32 cold", cold), ("ir cold", cold_ir),
                   ("f32 warm", warm)):
        log(f"[sv] {tag}: {r['requests']} requests in {r['wall_s']:.3f} s "
            f"= {r['solves_per_s']:.1f} solves/s, p50 {r['p50_ms']:.2f} ms,"
            f" p99 {r['p99_ms']:.2f} ms, max |X - X_unbatched|/max|X| "
            f"{r['max_rel_vs_unbatched']:.2e}, launches {r['launches']}")
    log(f"[sv] cache after the cold passes: {stats}")
    log(f"[sv] service summary: hit rate {summ['cache']['hit_rate']}, "
        f"build {summ['cache']['compile_s']:.2f} s, mean batch "
        f"{summ['mean_batch']}")

    # 4. servebench on the card, history and report in a temp dir
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        bench = {}
        for tag, argv in (("bench", SV_BENCH + ["--inject",
                                                "nan@serving:1:1"]),
                          ("soak", SV_SOAK)):
            rep = os.path.join(tmp, f"{tag}.json")
            pk.reset_counts()
            pdd.reset_counts()
            rc = servebench.main(argv + [
                "--report", rep, "--history",
                os.path.join(tmp, "history.jsonl"), "--seed",
                str(SV_SEED)])
            check(rc == 0, f"[servebench] {tag} exited {rc}")
            with open(rep) as f:
                doc = json.load(f)
            sv = doc["serving"]
            sv = sv[-1] if isinstance(sv, list) else sv
            bench[tag] = {k: sv.get(k) for k in (
                "solves_per_s", "loop_solves_per_s", "speedup_vs_loop",
                "measured_latency_s", "trace_overhead_frac",
                "admission_overhead_frac", "remediated", "failed",
                "injected_faults", "cache", "device")}
            bench[tag]["launches"] = {"k1": pk.LAUNCHES,
                                      "k1_batched": pk.BATCHED_LAUNCHES,
                                      "k2": pdd.LAUNCHES,
                                      "k2_batched": pdd.BATCHED_LAUNCHES}
            check(sv["failed"] == 0, f"[servebench] {tag}: {sv['failed']} "
                                     f"requests failed")
            if tag == "bench":
                check(sv["injected_faults"] >= 1 and sv["remediated"] >= 1,
                      f"[servebench] inject: {sv['injected_faults']} faults"
                      f", {sv['remediated']} remediated")
            else:
                audit = doc["admission"]["audit"]
                bench[tag]["audit"] = audit
                check(audit["balanced"] and audit["lost"] == 0
                      and audit["hung"] == 0
                      and audit["submitted"] == audit["admitted"]
                      + audit["shed"],
                      f"[servebench] soak audit {audit}")
            lat = sv["measured_latency_s"]
            log(f"[servebench] {tag}: {sv['solves_per_s']:.1f} solves/s "
                f"batched vs {sv['loop_solves_per_s']:.1f} one at a time "
                f"(x{sv['speedup_vs_loop']:.2f}), p50 "
                f"{1e3 * lat['p50']:.2f} ms, p99 {1e3 * lat['p99']:.2f} ms, "
                f"trace overhead {sv['trace_overhead_frac']}, admission "
                f"overhead {sv['admission_overhead_frac']}, remediated "
                f"{sv['remediated']}, launches {bench[tag]['launches']}"
                + (f", audit {bench[tag]['audit']}" if tag == "soak"
                   else ""))
    out["servebench"] = bench
    secs["servebench"] = time.perf_counter() - t0
    pk.enable(True)
    secs["total"] = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"[phase22] section seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    record["serving"] = out
    launches = {"k1": {}, "k2": {}}
    for tag, r in (("serving_f32", cold), ("serving_ir", cold_ir),
                   ("serving_f32_warm", warm)):
        launches["k1"][tag] = r["launches"]["k1_batched"]
        launches["k2"][tag] = r["launches"]["k2_batched"]
    for op, d in per_dispatch.items():
        launches["k1"][f"serving_dispatch_{op}"] = d["k1_batched"]
        launches["k2"][f"serving_dispatch_{op}"] = d["k2_batched"]
    for tag, d in bench.items():
        launches["k1"][f"servebench_{tag}"] = d["launches"]["k1_batched"]
        launches["k2"][f"servebench_{tag}"] = d["launches"]["k2_batched"]
    out["launches"] = launches
    return out


def batched_entry(name, source, line, cases, launches):
    """A kernels-line entry of a batched form: times summed over one
    dispatch of each replayed case (each case's time times its count a
    dispatch), launches from the phase's main-path runs."""
    keys = ("ms", "plain_ms", "bound_ms", "loop_ms")
    tot = {k: sum(c[k] * c["count"] for c in cases) for k in keys}
    lib = [c["library_ms"] for c in cases]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": line, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **tot, "bound_by": ("operations" if all(
                c["bound_by"] == "operations" for c in cases) else "bytes"),
            "library_ms": (None if any(x is None for x in lib)
                           else sum(x * c["count"]
                                    for x, c in zip(lib, cases))),
            "cases": cases}


def kt_entry(eigr):
    main_case = eigr["kt"]["cases"][f"shetrd_{N_EIG}"]
    return {"name": "kt_tridiag_bisect", "route": "cuda",
            "source": "dplasma_tpu_torch/kernels/csrc/tridiag_bisect.cu",
            "replaces": "dplasma_tpu/ops/eig.py:205",
            "launches": eigr["kt_launches"],
            "max_abs_err": max(c["max_abs_err"]
                               for c in eigr["kt"]["cases"].values()),
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "bound_ms_per_search", "plan")},
            "equal_at_every_held_index": all(
                c.get("equal", False) for c in eigr["kt"]["cases"].values()),
            "rates": eigr["kt"]["rates"],
            "by_case": eigr["kt"]["cases"]}


def kw_entry(eigr):
    r = eigr["kw_routes"]
    return {"name": "kw_sbr_window", "route": "cuda",
            "source": "dplasma_tpu_torch/kernels/csrc/sbr_window.cu",
            "replaces": "dplasma_tpu/ops/band.py:460",
            "launches": eigr["kw_launches"],
            "steps": eigr["kw_steps"],
            # f64 / c128 replays against the plain version
            "max_abs_err": max(x["max_abs_err"] for x in eigr["kw_replay"]
                               if x["dtype"] in ("torch.float64",
                                                 "torch.complex128")),
            "max_rel_err_f32_c64": max(
                x["worst_kw"] for x in eigr["kw_replay"]
                if x["dtype"] in ("torch.float32", "torch.complex64")),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "kw_cond": KW_COND,
            "barrier_us_a_step": eigr["kw_barrier"]["us_a_step"],
            "replays": [{k: x[k] for k in ("kind", "m", "n", "b", "w",
                                           "dtype", "steps", "slots",
                                           "checked", "windows_held",
                                           "worst_cond_kw",
                                           "worst_cond_plain",
                                           "kappa_at_worst_cond",
                                           "kappa_max", "worst_kw",
                                           "worst_plain", "median_ratio",
                                           "form", "ncta", "sweep_ms",
                                           "one_launch_equal", "step_us",
                                           "other_form", "other_form_ms",
                                           "form_ms",
                                           "plain_ms_held",
                                           "plain_step_us", "bound_ms",
                                           "bound_by")}
                        for x in eigr["kw_replay"]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from dplasma_tpu_torch.kernels import dd
    from dplasma_tpu_torch.kernels import pallas_dd as pdd
    from dplasma_tpu_torch.kernels import pallas_kernels as pk
    from dplasma_tpu_torch.kernels import pallas_lu as plu
    from dplasma_tpu_torch.kernels import pallas_qr as pqr
    from dplasma_tpu_torch.kernels import pallas_ring as pring

    t_start = time.perf_counter()
    record = {"device": torch.cuda.get_device_name(0), "phase_s": {}}
    # past WATCHDOG_S every thread's stack goes to stderr and the run
    # exits non-zero, so a run that would overrun its limit shows where
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        s = record["phase_s"][phase.__name__] = time.perf_counter() - t
        log(f"[time] {phase.__name__}: {s:.1f} s, "
            f"{time.perf_counter() - t_start:.1f} s into the run")
        return out

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {record['device']}")
    timed(phase_build, record)
    k1tot, nprod, k1cyc = timed(phase_k1, torch, pk, record)
    k1luqr = timed(phase_k1_lu_qr, torch, pk, record)
    k3tot, npan = timed(phase_k3, torch, plu, record)
    k4tot, nqpan = timed(phase_k4, torch, pqr, record)
    k2tot, nk2 = timed(phase_k2, torch, dd, pdd, record)
    k2luqr = timed(phase_k2_lu_qr, torch, dd, pdd, pk, record)
    k2ir = timed(phase_k2_ir, torch, dd, pdd, pk, record)
    timed(phase_int_mm_layouts, torch, record)
    k5tot = timed(phase_k5, torch, pring, record)
    k1_spotrf = timed(phase_spotrf, torch, pk, record)
    k1_sgetrf, k3_sgetrf = timed(phase_sgetrf, torch, pk, plu, record)
    timed(phase_sgetrf_profile, torch, pk, record)
    k1_sgeqrf, k4_sgeqrf = timed(phase_sgeqrf, torch, pk, plu, pqr, record)
    timed(phase_sgeqrf_profile, torch, pk, record)
    timed(phase_more_drivers, torch, pk, record)
    k2_dpotrf = timed(phase_dpotrf_dd, torch, pk, pdd, record)
    timed(phase_dpotrf_dd_profile, torch, record)
    k2_dgemm = timed(phase_dd_drivers, torch, pk, pdd, record)
    _, k5b_gt, k5s_gt, k1_gt = timed(phase_getrf_ptgpanel, torch, pk,
                                     pring, record)
    k5b_pc, k1_pc = timed(phase_potrf_cyclic, torch, pk, pring, record)
    ddf = timed(phase_dd_lu_qr, torch, pk, plu, pdd, record)
    timed(phase_dd_lu_qr_profile, torch, record)
    ir = timed(phase_ir, torch, pk, pdd, record)
    timed(phase_ir_profile, torch, pk, record)
    k1inv, k2inv, k1inv_by, k2inv_by = timed(phase_blas3_inverse, torch,
                                             pk, pdd, dd, record)
    k1cx, k2cx, k1cx_by, k2cx_by = timed(phase_complex_lu_family, torch,
                                         pk, pdd, dd, record)
    k1hq, k2hq, k1hq_by, k2hq_by = timed(phase_hqr_ldl, torch, pk, pdd, dd,
                                         record)
    eigr, k1eig = timed(phase_eig, torch, pk, pdd, record)
    _, k1lm, k1lm_by, k3lm_by = timed(phase_lowmem_catalogue, torch, pk,
                                      plu, record)
    _, k1cy, k1cy_by, k5b_qc, eig18 = timed(phase_cyclic_catalogue, torch,
                                            pk, pring, record)
    inst = timed(phase_instruments, torch, pk, plu, pqr, pdd, pring, record)
    live = timed(phase_live_instruments, torch, pk, pring, record,
                 os.path.join(HERE, "build", "phase19", "peaks.json"))
    p21 = timed(phase_dd_grid_resilience, torch, pk, pdd, dd, record)
    p22 = timed(phase_serving, torch, pk, pdd, record)
    for k in ("kw", "kt"):
        eigr[f"{k}_launches"] += eig18[k]
    eigr["kw_steps"] += eig18["kw_steps"]
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    k1_by_path = {path: dict({k: t[k] for k in keys},
                             bound_ffma_ms=t["bound_ffma_ms"],
                             products=t["products"])
                  for path, t in (("spotrf", k1tot), *k1luqr.items(),
                                  *k1cyc.items(), *k1inv.items(),
                                  *k1cx.items(), *k1hq.items(),
                                  *k1eig.items(), *k1lm.items(),
                                  *k1cy.items())}
    k5_launches = {"bcast": {"sgetrf_ptgpanel": k5b_gt,
                             "potrf_cyclic": k5b_pc,
                             "geqrf_cyclic": k5b_qc,
                             "instruments": inst["k5_bcast"],
                             "live_instruments": live["k5_bcast"]},
                   "shift": {"sgetrf_ptgpanel": k5s_gt,
                             "instruments": inst["k5_shift"],
                             "live_instruments": live["k5_shift"]}}

    def k5_entry(kind, line):
        paths = k5tot[kind]
        by_path = {path: dict({k: t[k] for k in keys},
                              launches=k5_launches[kind][path],
                              launches_per_factorization=t[
                                  "launches_per_factorization"])
                   for path, t in paths.items()}
        return {"name": f"k5_ring_{kind}", "route": "cuda",
                "source": "dplasma_tpu_torch/kernels/csrc/ring.cu",
                "replaces": f"dplasma_tpu/kernels/pallas_ring.py:{line}",
                "launches": sum(k5_launches[kind].values()),
                "launches_by_path": k5_launches[kind],
                "max_abs_err": max(t["max_abs_err"]
                                   for t in paths.values()),
                **{k: sum(t[k] for t in paths.values()) for k in keys},
                "bound_by": "bytes", "by_path": by_path}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    record["nvidia_smi"] = smi
    kernels = {"kernels": [
        {"name": "k1_gemm", "route": "cuda",
         "source": "dplasma_tpu_torch/kernels/csrc/gemm.cu",
         "replaces": "dplasma_tpu/kernels/pallas_kernels.py:139",
         "launches": (k1_spotrf + k1_sgetrf + k1_sgeqrf + k1_gt + k1_pc
                      + ddf["k1"]["dgeqrf_dd"] + sum(ir["k1"].values())
                      + sum(k1inv_by.values()) + sum(k1cx_by.values())
                      + sum(k1hq_by.values()) + sum(eigr["k1_by"].values())
                      + sum(k1lm_by.values()) + sum(k1cy_by.values())
                      + inst["k1"] + live["k1"] + sum(p21["k1"].values())),
         "launches_by_path": dict({"spotrf": k1_spotrf, "sgetrf": k1_sgetrf,
                                   "sgeqrf": k1_sgeqrf,
                                   "sgetrf_ptgpanel": k1_gt,
                                   "potrf_cyclic": k1_pc,
                                   "dgeqrf_dd": ddf["k1"]["dgeqrf_dd"]},
                                  **ir["k1"], **k1inv_by, **k1cx_by,
                                  **k1hq_by, **eigr["k1_by"], **k1lm_by,
                                  **k1cy_by, instruments=inst["k1"],
                                  live_instruments=live["k1"], **p21["k1"]),
         "max_abs_err": max([k1tot["max_abs_err"]]
                            + [t["max_abs_err"] for t in k1cyc.values()]
                            + [t["max_abs_err"] for t in k1luqr.values()]
                            + [t["max_abs_err"] for t in k1inv.values()]
                            + [t["max_abs_err"] for t in k1cx.values()]
                            + [t["max_abs_err"] for t in k1hq.values()]
                            + [t["max_abs_err"] for t in k1eig.values()]
                            + [t["max_abs_err"] for t in k1lm.values()]
                            + [t["max_abs_err"] for t in k1cy.values()]),
         "ms": k1tot["ms"], "plain_ms": k1tot["plain_ms"],
         "bound_ms": k1tot["bound_ms"], "bound_by": "operations",
         "library_ms": k1tot["library_ms"], "by_path": k1_by_path},
        {"name": "k2_limb_gemm", "route": "cuda",
         "source": "dplasma_tpu_torch/kernels/csrc/recombine.cu",
         "replaces": "dplasma_tpu/kernels/pallas_dd.py:83",
         "launches": (k2_dpotrf + k2_dgemm + sum(ddf["k2"].values())
                      + sum(ir["k2"].values()) + sum(k2inv_by.values())
                      + sum(k2cx_by.values()) + sum(k2hq_by.values())
                      + sum(eigr["k2_by"].values()) + inst["k2"]
                      + sum(p21["k2"].values())),
         "launches_by_path": dict({"dpotrf_dd": k2_dpotrf,
                                   "dgemm_dd": k2_dgemm}, **ddf["k2"],
                                  **ir["k2"], **k2inv_by, **k2cx_by,
                                  **k2hq_by, **eigr["k2_by"],
                                  instruments=inst["k2"], **p21["k2"]),
         "max_abs_err": max([k2tot["max_abs_err"]]
                            + [t["max_abs_err"] for t in k2cx.values()]
                            + [t["max_abs_err"] for t in k2hq.values()]
                            + [t["max_abs_err"]
                               for t in p21["k2_paths"].values()]),
         "ms": k2tot["ms"], "plain_ms": k2tot["plain_ms"],
         "bound_ms": k2tot["bound_ms"], "bound_by": k2tot["bound_by"],
         "library_ms": k2tot["library_ms"],
         "limb_levels_ms": k2tot["limb_levels_ms"],
         "dgemm": {k: record["k2_main_path"]["dgemm"][k]
                   for k in ("ms", "limb_levels_ms", "plain_ms",
                             "bound_ms", "library_ms")},
         "by_path": {path: dict({k: t[k] for k in (
             "ms", "limb_levels_ms", "plain_ms", "bound_ms", "library_ms",
             "max_abs_err", "bound_by")}, launches=t["launches"],
             shapes=len(t["shapes"])) for path, t in (*k2luqr.items(),
                                                      *k2ir.items(),
                                                      *k2inv.items(),
                                                      *k2cx.items(),
                                                      *k2hq.items(),
                                                      *p21["k2_paths"].items())}},
        {"name": "k3_lu_panel", "route": "cuda",
         "source": "dplasma_tpu_torch/kernels/csrc/lu_panel.cu",
         "replaces": "dplasma_tpu/kernels/pallas_lu.py:121",
         "launches": (k3_sgetrf + ddf["k3"]["dgetrf_dd"]
                      + ir["k3"]["gesv_ir"] + sum(k3lm_by.values())
                      + inst["k3"]),
         "launches_by_path": {"sgetrf": k3_sgetrf,
                              "dgetrf_dd": ddf["k3"]["dgetrf_dd"],
                              "gesv_ir": ir["k3"]["gesv_ir"], **k3lm_by,
                              "instruments": inst["k3"]},
         "max_abs_err": k3tot["max_abs_err"],
         "ms": k3tot["ms"], "plain_ms": k3tot["plain_ms"],
         "bound_ms": k3tot["bound_ms"],
         "bound_by": lu_bound_ms(N_LU, NB_LU)[1],
         "library_ms": k3tot["library_ms"]},
        {"name": "k4_geqrt_panel", "route": "cuda",
         "source": "dplasma_tpu_torch/kernels/csrc/geqrt_panel.cu",
         "replaces": "dplasma_tpu/kernels/pallas_qr.py:123",
         "launches": k4_sgeqrf + ir["k4"]["gels_ir"] + inst["k4"],
         "launches_by_path": {"sgeqrf": k4_sgeqrf,
                              "gels_ir": ir["k4"]["gels_ir"],
                              "instruments": inst["k4"]},
         "max_abs_err": k4tot["max_abs_err"],
         "ms": k4tot["ms"], "plain_ms": k4tot["plain_ms"],
         "bound_ms": k4tot["bound_ms"],
         "bound_by": qr_bound_ms(N_QR, NB_QR)[1],
         "library_ms": k4tot["library_ms"]},
        k5_entry("bcast", 321), k5_entry("shift", 357),
        kt_entry(eigr), kw_entry(eigr),
        batched_entry("k1_gemm_batched",
                      "dplasma_tpu_torch/kernels/csrc/gemm.cu",
                      "dplasma_tpu/kernels/pallas_kernels.py:139",
                      p22["k1_cases"], p22["launches"]["k1"]),
        batched_entry("k2_limb_gemm_batched",
                      "dplasma_tpu_torch/kernels/csrc/recombine.cu",
                      "dplasma_tpu/kernels/pallas_dd.py:83",
                      p22["k2_cases"], p22["launches"]["k2"])]}
    record.update(kernels)
    record["wall_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    log(f"[note] K1 ms/plain_ms/bound_ms/library_ms are sums over the "
        f"{nprod} K1 products of one spotrf factorization (N={N_MAIN}, "
        f"nb={NB_MAIN}); K3's over the {npan} panels of one sgetrf "
        f"factorization (N={N_LU}, nb={NB_LU}; library = "
        f"torch.linalg.lu_factor_ex on cuSOLVER); K4's over the {nqpan} "
        f"panels of one sgeqrf factorization (N={N_QR}, nb={NB_QR}; "
        f"library = torch.geqrf on cuSOLVER); K2's over the {nk2} "
        f"launches of one dd dpotrf factorization (N={N_DD}, nb={NB_DD}; "
        f"K2 is the whole limb product with its recombine; library = "
        f"native FP64 torch.addmm on the f64 operands, not the same bits; "
        f"limb_levels_ms = the unfused route's int8 products and level "
        f"sums on torch._int_mm; bound = max(int8 operations at "
        f"{INT8_OPS / 1e12:.0f} TOP/s, bytes at HBM rate); dgemm = one "
        f"dd product at {N_DD}^3; by_path: the launches of one dgetrf dd "
        f"(N={N_DDF}, nb={NB_DDF}, and nb={NB_DDK3}) and one dgeqrf dd "
        f"(nb={NB_DDF}, chain and tree panels) factorization, each distinct "
        f"shape timed on random operands times its count); launches "
        f"count each main-path driver run (warm-up, timed run, -x check), "
        f"K2's the direct dpotrf call, the dgemm driver run and phase "
        f"11's direct dgetrf (nb={NB_DDK3}, lu.agg_depth 4) and dgeqrf "
        f"(chain and tree) calls, K3's also that dgetrf's f32 seeds, K1's "
        f"also those dgeqrf calls' f32 seed LUs; the *_ir paths count "
        f"phase 12's driver runs (warm-up, timed run, -x check) at every "
        f"rung: K2 every residual and f32x2 step, K1 the f32 factors' "
        f"products, K3 gesv_ir's panels, K4 gels_ir's; K2's *_ir_f32x2 "
        f"by_path entries time each shape of one f32x2 solve (N={N_IR}); "
        f"phase 13: K1's by_path strtri, slauum, ssymm, ssyrk, ssyr2k, "
        f"strmm and strsm sum each distinct product of one direct call "
        f"(trtri/lauum N={N_INV}, nb={NB_INV}; BLAS-3 {N_B3}, nb={NB_B3}) "
        f"times its count, spotri = strtri + slauum, spoinv = spotri + "
        f"spotrf; its launches_by_path count each phase 13 driver run "
        f"(warm-up, timed run, -x check, and potri's untimed potrf); K2's "
        f"dpoinv_dd by_path times each shape of one dd poinv (N={N_DD}, "
        f"nb={NB_DD}), its launches_by_path the dd dpotri and dpoinv "
        f"driver runs; phase 14: K2's by_path zpotrf_dd (N={N_ZDD}, "
        f"nb={NB_ZDD}), zgetrf_dd and zgeqrf_dd (N={N_ZDD_LU}, "
        f"nb={NB_ZDD}) and dgetrf_incpiv_dd (N={N_LUF_DD}, nb={NB_LUF}) "
        f"time each shape of one direct call (a complex product is two "
        f"2K-deep launches), K1's by_path sgetrf_incpiv, sgetrs_incpiv "
        f"(sgesv_incpiv = both) and sgetrf_qrf (N={N_LUF}, nb={NB_LUF}) "
        f"each distinct product of one direct call; their "
        f"launches_by_path count each phase 14 driver run (warm-up, timed "
        f"run, -x check); phase 15: K1's by_path sgeqrf_hqr (the "
        f"default tree), sgeqrf_hqr_a4 (--qr_a 4 --treeh 1), sgeqrf_rd, "
        f"sgelqf_hqr, sunmqr_hqr, sunmlq_hqr, shetrf and shebut (N={N_HQR},"
        f" nb={NB_HQR}) each distinct product of one direct call (each "
        f"shape held and timed once), K2's dgeqrf_hqr_dd and dhetrf_dd "
        f"(N={N_HQR_SMALL}) each shape of one direct call; their "
        f"launches_by_path count each phase 15 driver run (warm-up, timed "
        f"run, -x check); phase 16: K1's by_path sheev_2stage_windows (N="
        f"{N_EIG}, nb={NB_EIG}) each distinct product of one direct call with "
        f"every dimension at most the first sweep's window (its window "
        f"products and the last stage-1 panels'), its "
        f"launches_by_path and K2's (dhetrd_dd, dgesvd_dd at "
        f"{N_EIG_DRIVERS}) each phase 16 driver run (one timed run, no "
        f"warm-up), the two direct heev 2stage calls and the stage-timed "
        f"heev 2stage and sgesvd; KT's ms/plain_ms/"
        f"bound_ms/library_ms are one tridiagonal of an shetrd at N={N_EIG} "
        f"(library = torch.linalg.eigvalsh of the dense tridiagonal; "
        f"bound = the shared tree's Sturm steps at the division rate or "
        f"the operations or bytes rate, whichever is largest, "
        f"bound_ms_per_search the n^2 levels operations bound of one "
        f"search a value; "
        f"by_case also the same cast to f64, a dhetrd's at {N_EIG_SMALL} "
        f"and the sgesvd ({N_EIG}) and dgesvd ({N_EIG_DRIVERS}) driver "
        f"runs' Jordan–Wielandt tridiagonals, whose ms is the launch of "
        f"the top K gesvd asks for and full_ms all values; the plain "
        f"version on the host over {KT_SAMPLE} + 5 indices, held "
        f"torch.equal), KW's the sweeps it takes "
        f"(b <= 128) of one shetrd and one sgebrd at N={N_EIG_ROUTES} "
        f"through KW and through the plain version (bound from the live "
        f"windows' strips and applies; no library call computes a window "
        f"step; replays: each sweep at {N_EIG} f32, {N_EIG_SMALL} c/d/z in "
        f"one launch, its steps, us a step, bound and the plain version's "
        f"time over the held steps); its launches (one a sweep) and steps "
        f"are counted in each phase 16 driver run and "
        f"around each of the two direct heev 2stage calls; KW's "
        f"max_abs_err is the f64/c128 replays' worst against the plain "
        f"version on random storage (max_rel_err_f32_c64 the f32/c64 "
        f"replays' worst distance to the step in twice the precision; "
        f"every slot of every held step within kw_cond eps kappa of its "
        f"reference); "
        f"K1's "
        f"bound_ms is the 3xTF32 bound (3 passes of 2MNK at the TF32 "
        f"tensor-core peak), bound_ffma_ms the FP32 FFMA one; by_path "
        f"gives K1's sums over one factorization of spotrf, sgetrf and "
        f"sgeqrf (N={N_LU}, nb={NB_LU}; products recorded from one "
        f"factorization), sgetrf_ptgpanel (N={N_GT}, nb={NB_GT}) and "
        f"potrf_cyclic "
        f"(N={N_PC}, nb={NB_PC}), grid {GRID[0]}x{GRID[1]}, whose "
        f"launches are the driver run (warm-up, timed run, -x check) and "
        f"one timed potrf_cyclic call; K5's ms/plain_ms/bound_ms/"
        f"library_ms sum one factorization of each path that launches it "
        f"(by_path: each launch of one shape, timed once, times the "
        f"count; library = the root's block expanded and made contiguous "
        f"for a broadcast, the rotated blocks stacked for a shift), "
        f"launches the sgetrf_ptgpanel driver run (warm-up and timed run) "
        f"and the timed potrf_cyclic call; phase 17: K1's by_path "
        f"spotrf_lowmem (N={N_LM_S}, nb={NB_LM}), sgetrf_lowmem and "
        f"sgeqrf_lowmem (N={N_LM_LU}) and sgemm_stream ({N_STREAM}^3) each "
        f"distinct product of the one timed call, held and timed once "
        f"times its count; K1's and K3's launches_by_path count each "
        f"phase 17 call (the lowmem tiers, gemm_ex stream, potrf_lapack) "
        f"and driver run (warm-up, timed run, -x check); phase 18 (grid "
        f"{GRID[0]}x{GRID[1]}): K1's by_path potrf_cyclic_U and "
        f"potrs_cyclic_L/U (N={N_PC}, nb={NB_PC}), getrs_cyclic, "
        f"trsm_cyclic_LN, gemm_cyclic, gemm_ex_summa, herk/trmm/hemm/her2k/"
        f"lauum/trtri/potri_cyclic (N={N_QC}, nb={NB_QC}), geqrf_cyclic "
        f"({N_QC}x{N_QC_COLS}), "
        f"herbt_cyclic and ge2gb_cyclic (N={N_EIG}, nb={NB_EIG}) each "
        f"distinct product of one call recorded through the wrapper, held "
        f"and timed once times its count; their launches_by_path count "
        f"the first timed call of each (heev_cyclic and gesvd_cyclic too, "
        f"whose KW and KT launches add to KW's and KT's); K5's "
        f"geqrf_cyclic its timed call's broadcasts, by_path the ptgpanel "
        f"broadcast's shape times them; phase 19: each kernel's "
        f"launches_by_path instruments counts the phase 19 driver runs "
        f"with the instruments' flags (warm-up, timed run, attributed "
        f"pass, -x check) and, for K5, the ring probe of the potrf_cyclic "
        f"call under a ledger; phase 20: K1's and K5's launches_by_path "
        f"live_instruments count its spotrf and sgetrf_ptgpanel driver runs "
        f"(plain and with --devprof --telemetry: warm-up, timed run, -x "
        f"check); phase 21 (grid {GRID[0]}x{GRID[1]}, dd_gemm=always): "
        f"K2's by_path potrf_cyclic_dd (N={N_DDC}, nb={NB_DDC}) each "
        f"distinct limb product of one call, recorded through the wrapper, "
        f"held bitwise and timed times its count; its launches_by_path "
        f"potrf_cyclic_dd its {NRUNS_DDC} timed calls, getrf_ptgpanel_dd "
        f"the driver's timed run (nb={NB_DDC_LU}), cyclic_dd_ops the other "
        f"ops' one call each (N={N_DDC_OPS}, nb={NB_DDC_OPS}), "
        f"dpotrf_dd_abft the plain and --abft dd dpotrf timed runs; K1's "
        f"spotrf_abft_<case> every run of every attempt of the --abft "
        f"--inject=bitflip spotrf runs (default, overflow, silent; the "
        f"primary on the {N_MAIN + NB_MAIN}-row bordered matrix); phase "
        f"22: k1_gemm_batched / k2_limb_gemm_batched are the batched "
        f"launches of the serving layer (stacks of {SV_BATCH}, nb="
        f"{NB_SV}): ms, plain_ms, loop_ms (a loop of 2-D launches), "
        f"library_ms (K1: torch.bmm or baddbmm; K2: none) and bound_ms "
        f"sum one batched dispatch's products at each bucket (K1: posv and "
        f"gesv at {SV_K1_SIZES}, plus a broadcast and an FFMA case; K2: "
        f"posv_ir and gesv_ir residuals at {SV_K2_SIZES}), each replayed "
        f"layout timed once times its count a dispatch; launches_by_path "
        f"count the batched launches of the SolverService traffic (cold "
        f"f32, cold IR, warm f32), of one full dispatch per op and of the "
        f"servebench runs")
    log(f"[note] chip_smoke took {record['wall_s']:.1f} s")
    faulthandler.cancel_dump_traceback_later()
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
