"""cornetto-tpu: a JAX/XLA framework with the capabilities of the Cornetto
genome-assembly adaptive-sampling toolkit, whose device paths run on an
NVIDIA GPU.

Reference behavior parity: hasindu2008/cornetto (C99); see SURVEY.md for the
structural map.  Layout:

- ``io``        host-side format layer (FASTA/FASTQ, BED/bedgraph, PAF, BAM, EPS)
- ``intervals`` device/host interval algebra (bedtools replacement)
- ``kernels``   JAX/XLA compute kernels (window scans, motif scans, minimizers)
- ``tools``     the 16 subcommand equivalents (byte-identical outputs)
- ``pipelines`` panel-generation / evaluation protocol pipelines
- ``dist``      multi-device mesh runtime (sharding, halo exchange, collectives)
- ``livefish``  real-time adaptive-sampling decision loop (sharded minimizer index)
"""

from cornetto_tpu.version import __version__

__all__ = ["__version__"]
