"""Genome-scale ingestion + fit demo (BASELINE config 3 shape).

Synthesizes a whole-genome single-diploid VCF (22 chromosomes, ~3 Gbp of
coordinates, ~1 het/kb), stream-ingests it through the C tokenizer into
>=50k overlapping chunks, uploads the chunk tensor to the device, and runs
SVGD fit iterations with the production kernel.  Reports wall time per
stage, peak host RSS (ingestion must stay memory-bounded), chunk-tensor
size, per-step time, and device HBM in use.

Run on the GPU host:   python tools/genome_scale_demo.py
Quick CPU smoke test:  python tools/genome_scale_demo.py --scale 0.01 --cpu

Results are recorded in docs/GENOME_SCALE.md.
"""

from __future__ import annotations

import argparse
import gzip
import os
import resource
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CHROM_MB = [248, 242, 198, 190, 182, 171, 159, 145, 138, 134,
            135, 133, 114, 107, 102, 90, 83, 80, 59, 64, 47, 51]  # ~3.07 Gbp


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def synth_chromosome(path: str, chrom: str, length: int, rng: np.random.Generator,
                     het_per_bp: float = 1e-3) -> int:
    "Write a sorted single-diploid VCF with Poisson het sites; returns #records."
    n = rng.poisson(het_per_bp * length)
    pos = np.sort(rng.choice(length, size=n, replace=False)) + 1
    # mix of het (0/1) and hom-alt (1/1) calls plus a few missing
    kind = rng.choice(3, size=n, p=[0.85, 0.12, 0.03])
    gt = np.array(["0/1", "1/1", "./."])[kind]
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={length}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tNA00001\n")
        rows = "\n".join(
            f"{chrom}\t{p}\t.\tA\tT\t.\tPASS\t.\tGT\t{g}" for p, g in zip(pos, gt)
        )
        f.write(rows + "\n")
    return int(n)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0, help="genome size multiplier")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--niter", type=int, default=30)
    ap.add_argument("--window", type=int, default=100)
    ap.add_argument("--chunk-size", type=int, default=500, help="windows per chunk")
    ap.add_argument("--overlap", type=int, default=100)
    ap.add_argument("--particles", type=int, default=500)
    ap.add_argument(
        "--holdout",
        action="store_true",
        help="hold out chr22 and measure the fused held-out-ELPD overhead "
        "(an ELPD-bearing call vs a plain call at the 10-iteration cadence)",
    )
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import phlash_tpu
    from phlash_tpu.data import init_mcmc_data

    rng = np.random.default_rng(0)
    tdir = tempfile.mkdtemp(prefix="phlash_genome_")
    total_bp = 0
    t0 = time.perf_counter()
    paths = []
    for i, mb in enumerate(CHROM_MB, 1):
        length = int(mb * 1e6 * args.scale)
        p = os.path.join(tdir, f"chr{i}.vcf.gz")
        synth_chromosome(p, f"chr{i}", length, rng)
        paths.append((p, f"chr{i}", length))
        total_bp += length
    t_synth = time.perf_counter() - t0
    vcf_bytes = sum(os.path.getsize(p) for p, _, _ in paths)
    print(f"synthesized {total_bp/1e9:.2f} Gbp across {len(paths)} chromosomes "
          f"({vcf_bytes/1e6:.0f} MB gz) in {t_synth:.1f}s; RSS {rss_gb():.2f} GB")

    holdout = None
    if args.holdout:  # chr22 becomes the held-out ELPD contig
        holdout, paths = paths[-1], paths[:-1]

    t0 = time.perf_counter()
    contigs = [
        phlash_tpu.contig(p, samples=["NA00001"], region=f"{c}:1-{L}")
        for p, c, L in paths
    ]
    afs, chunks = init_mcmc_data(
        contigs,
        window_size=args.window,
        overlap=args.overlap,
        chunk_size=args.chunk_size,
        num_workers=8,
    )
    t_ingest = time.perf_counter() - t0
    print(f"ingested -> {chunks.shape[0]} chunks x {chunks.shape[1]} cols "
          f"({chunks.nbytes/1e6:.0f} MB int8) in {t_ingest:.1f}s "
          f"({total_bp/t_ingest/1e6:.0f} Mbp/s); peak RSS {rss_gb():.2f} GB")

    # drive the training program directly so the FULL chunk tensor stays
    # device-resident (fit() would downsample it for a short demo run)
    from phlash_tpu.training import build_training

    options = dict(
        num_particles=args.particles, minibatch_size=5, niter=args.niter
    )
    t0 = time.perf_counter()
    prog = build_training(
        chunks, afs, window_size=args.window, overlap=args.overlap,
        key=jax.random.PRNGKey(0), options=options,
    )
    step = jax.jit(prog.step)
    key = jax.random.PRNGKey(1)
    key, sub = jax.random.split(key)
    state = jax.block_until_ready(step(prog.state, sub))  # compile + step 0
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.niter - 1):
        key, sub = jax.random.split(key)
        state = step(state, sub)
    jax.block_until_ready(state)
    t_fit = time.perf_counter() - t0
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    ms = t_fit / max(1, args.niter - 1) * 1e3
    if stats.get("peak_bytes_in_use"):
        mem = (f"device memory in use {stats['bytes_in_use']/1e9:.2f} GB "
               f"(peak {stats['peak_bytes_in_use']/1e9:.2f} GB)")
    else:  # a backend without memory stats
        mem = f"device-resident chunk tensor {chunks.nbytes/1e6:.0f} MB"
    print(f"fit: upload+compile+first step {t_compile:.1f}s; "
          f"{args.niter - 1} steps x {args.particles} particles in {t_fit:.1f}s "
          f"({ms:.0f} ms/step) on {dev.platform}; {mem}")
    from phlash_tpu.params import MCMCParams
    med = float(np.median(np.asarray(
        jax.vmap(lambda p: MCMCParams.to_dm(p).eta.c[0])(state.particles))))
    print(f"posterior median c[0] after {args.niter} steps: {med:.3f}")

    if holdout is not None:
        # --- fused held-out ELPD overhead (r3 verdict weak item 3) -------
        # Build exactly the graph fit() dispatches on an ELPD-bearing call
        # (mcmc.py step_of(with_elpd=True)): the steps_per_call chain plus
        # the subsampled held-out density, one dispatch.  Overhead is
        # (ELPD call - plain call) / plain call; at the default cadence
        # (one ELPD-bearing call per 10 iterations with steps_per_call=10,
        # i.e. every call) this is also the fit-level overhead.
        from phlash_tpu.data import chunk_het_matrix
        from phlash_tpu.kernel import get_kernel
        from phlash_tpu.model import log_density_batched

        p_h, c_h, L_h = holdout
        test_contig = phlash_tpu.contig(p_h, samples=["NA00001"], region=f"{c_h}:1-{L_h}")
        het = test_contig.get_data(args.window)["het_matrix"]
        chunk_span = int(chunks.shape[-1])
        test_chunks = chunk_het_matrix(
            het, overlap=args.overlap, chunk_size=chunk_span - args.overlap
        )
        N_test = len(test_chunks)
        S_elpd = min(N_test, max(prog.S, 4))
        test_kern = get_kernel(
            M=prog.init.M, data=np.ascontiguousarray(test_chunks[:, args.overlap:])
        )
        test_warmup = jax.numpy.asarray(
            np.ascontiguousarray(test_chunks[:, : args.overlap]), dtype=jax.numpy.int8
        )

        def fused(s, kk):
            s2 = prog.step(s, kk)
            inds = jax.random.choice(
                jax.random.fold_in(kk, 0x0E1D), N_test, (S_elpd,), replace=False
            )
            e = log_density_batched(
                s2.particles,
                c=jax.numpy.array([0.0, 1.0, 1.0], dtype=jax.numpy.float32),
                inds=inds,
                warmup=test_warmup[inds],
                kern=test_kern,
                afs=None,
                afs_transform=None,
            ).mean()
            return s2, e

        fused_j = jax.jit(fused)
        s2, e = fused_j(state, key)
        jax.block_until_ready(s2)

        def best_of(fn, unpack, reps=3, inner=5):
            best = float("inf")
            kk = key
            for _ in range(reps):
                t0 = time.perf_counter()
                s = state
                for _ in range(inner):
                    kk, sub = jax.random.split(kk)
                    s = unpack(fn(s, sub))
                jax.block_until_ready(s)
                best = min(best, (time.perf_counter() - t0) / inner)
            return best

        t_plain = best_of(step, lambda o: o)
        t_fused = best_of(fused_j, lambda o: o[0])  # (state, elpd) aux pair
        spc = prog.steps_per_call
        # one ELPD evaluation per 10 iterations = per ceil(10/spc) calls;
        # the added cost is amortized over those 10 iterations of fit time
        calls_per_eval = max(1, -(-10 // spc))
        overhead = (t_fused - t_plain) / (calls_per_eval * t_plain)
        print(
            f"held-out ELPD (chr22, {N_test} chunks, {S_elpd}/eval): "
            f"plain call {t_plain * 1e3:.1f} ms, ELPD-bearing call "
            f"{t_fused * 1e3:.1f} ms ({spc} iters/call) -> fit overhead "
            f"{overhead * 100:.1f}% at the 10-iteration ELPD cadence"
        )


if __name__ == "__main__":
    main()
