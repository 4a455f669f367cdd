"""Process-pool guard: ingestion workers must never touch the GPU.

Workers do pure numpy/IO work; the initializer pins any JAX import inside a
worker to the CPU platform so spawned processes cannot reserve the card's
memory (reference behavior: upstream phlash/mp.py:6-18).
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor


def _pin_worker_to_cpu():
    os.environ["TF_CPP_MIN_LOG_LEVEL"] = "2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


class CpuProcessPoolExecutor(ProcessPoolExecutor):
    "Spawn-context pool whose workers are pinned to the CPU platform."

    def __init__(self, max_workers=None, **kwargs):
        ctx = multiprocessing.get_context("spawn")
        super().__init__(
            max_workers, initializer=_pin_worker_to_cpu, mp_context=ctx, **kwargs
        )
