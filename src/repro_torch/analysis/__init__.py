"""Analysis tools of the port: the H100 roofline
(:mod:`repro_torch.analysis.roofline`)."""
