from phylo_tpu_torch.oracle.reference_vcsmc import OracleVCSMC  # noqa: F401
