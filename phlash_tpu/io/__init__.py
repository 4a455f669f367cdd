"""Native-accelerated ingestion helpers.

Device compute lives in Pallas/XLA; host-side ingestion of genome files
is the remaining hot loop.  `fastvcf` provides a C tokenizer
for VCF genotype columns (built on demand with the system compiler, loaded
via ctypes); phlash_tpu.data falls back to the pure-Python parser when the
extension is unavailable, so the dependency is strictly optional.
"""

from phlash_tpu.io.fastvcf import parse_vcf_lines, vcf_parser_backend

__all__ = ["parse_vcf_lines", "vcf_parser_backend"]
