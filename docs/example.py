"""Executable end-to-end walkthrough: BCF -> fit -> plot -> confidence band.

The runnable counterpart of the reference's notebooks/example.md
(/root/reference/notebooks/example.md), sized to finish in a few minutes on
one CPU core; on a GPU host the same script runs unmodified and simply
picks the triton kernel.  Exercised by the slow test lane
(tests/test_example.py), so every step below is continuously verified.

What it shows, in order:

1. simulate a genome from the exact continuous-time SMC' process under a
   bottleneck demography (no real data needed for a demo);
2. write it as a standard BCF (phlash_tpu ships its own BCF writer/reader,
   no htslib/pysam required) — in real use, start at step 3 with your file;
3. load it with ``phlash_tpu.contig(path, samples=, region=)``;
4. ``fit()`` with the production options: a device mesh, checkpointing,
   and strided dispatch (steps_per_call);
5. plot the posterior and compute a simultaneous confidence band.

Run:    python docs/example.py [output_dir]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import phlash_tpu
from phlash_tpu.cband import confidence_band
from phlash_tpu.io.bcf import write_bcf
from phlash_tpu.parallel import make_mesh
from phlash_tpu.sim import bottleneck_demography, simulate_smc_continuous

WINDOW = 100  # bp per het-matrix column


def simulate_to_bcf(path: str, L_windows: int = 150_000, seed: int = 1):
    """Steps 1-2: draw a diploid contig and write it as an indexed BCF.

    A window with >= 1 heterozygous call becomes one het variant record at
    the window's midpoint; everything else is homozygous reference (the
    walkthrough keeps the masking story out of scope).
    """
    truth = bottleneck_demography(theta=1e-2)
    contig = simulate_smc_continuous(truth, L=L_windows, seed=seed, window_size=WINDOW)
    het = np.asarray(contig.het_matrix[0])
    span = L_windows * WINDOW
    header = "\n".join(
        [
            "##fileformat=VCFv4.2",
            '##FILTER=<ID=PASS,Description="All filters passed">',
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
            f"##contig=<ID=chr1,length={span}>",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample1",
        ]
    )
    records = [
        ("chr1", int(w) * WINDOW + WINDOW // 2, "A", ["T"], [(0, 1)])
        for w in np.flatnonzero(het == 1)
    ]
    write_bcf(path, header, records, index=True)
    return truth, span


def main(outdir: str = None):
    outdir = outdir or tempfile.mkdtemp(prefix="phlash_tpu_example_")
    os.makedirs(outdir, exist_ok=True)
    bcf_path = os.path.join(outdir, "example.bcf")

    print("1-2. simulating a 15 Mb diploid contig and writing", bcf_path)
    truth, span = simulate_to_bcf(bcf_path)

    # 3. load: samples= and region= are required for VCF/BCF, exactly as in
    # the reference API (a guard against silently analyzing telomeres)
    print("3.   loading the contig")
    train = phlash_tpu.contig(bcf_path, samples=["sample1"], region=f"chr1:1-{span * 4 // 5}")
    held_out = phlash_tpu.contig(
        bcf_path, samples=["sample1"], region=f"chr1:{span * 4 // 5 + 1}-{span}"
    )

    # 4. fit.  The options shown are the production set:
    #    mesh=            shard particles/data over every attached device
    #    checkpoint_path= resume an interrupted run from the last save
    #    steps_per_call=  chain SVGD iterations inside one dispatch
    #    test_data=       held-out ELPD early stopping
    print("4.   fitting (small run: 40 iterations, 32 particles)")
    posterior = phlash_tpu.fit(
        [train],
        test_data=held_out,
        mesh=make_mesh(),
        checkpoint_path=os.path.join(outdir, "fit_ckpt.npz"),
        steps_per_call=5,
        niter=40,
        num_particles=32,
        overlap=100,
        chunk_size=5000,
        num_workers=1,
        elpd_cutoff=30,
        progress=False,
    )
    print(f"     posterior: {len(posterior)} DemographicModel samples")

    # 5a. static plot of the posterior Ne(t) band
    fig_path = os.path.join(outdir, "posterior.png")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        phlash_tpu.plot_posterior(posterior, ax=ax)
        fig.savefig(fig_path, dpi=100)
        print("5a.  wrote", fig_path)
    except ImportError:
        print("5a.  matplotlib not available; skipping the figure")

    # 5b. simultaneous 95% confidence band on Ne(t) (MILP, scipy/HiGHS).
    # lo/hi bound Ne(t) = 1/(2 c(t)): evaluate with Ne=True to compare.
    lo, hi = confidence_band(posterior)
    t = np.asarray(lo.t)
    assert np.all(np.asarray(hi(t, Ne=True)) >= np.asarray(lo(t, Ne=True)) - 1e-9)
    print("5b.  confidence band: lower/upper Ne(t) over", len(t), "grid points")

    # sanity: the posterior median coalescence scale should bracket the
    # truth's order of magnitude even in this tiny demo run
    med_c = float(np.median(np.concatenate([np.asarray(dm.eta.c) for dm in posterior])))
    print(f"     posterior median c = {med_c:.3f} (truth is O(1))")
    print("DONE:", outdir)
    return outdir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
