"""flashfry_tpu: a CRISPR target-characterization engine on a JAX accelerator.

Brand-new implementation with the capabilities of FlashFry
(McKenna & Shendure, BMC Biology 2018), re-architected for JAX/XLA/Pallas:
the genome off-target database is a device-resident columnar array store,
the mismatch scan runs as one-hot int8 matmuls (a fused Pallas kernel on the
GPU), and scoring is vectorized over the collected off-target sets.
"""

__version__ = "0.1.0"
