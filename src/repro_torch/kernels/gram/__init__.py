from repro_torch.kernels.gram.ops import weighted_gram  # noqa: F401
