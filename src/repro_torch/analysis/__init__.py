"""Analysis tools of the port: the H100 roofline
(:mod:`repro_torch.analysis.roofline`) and the port's static checker
(:mod:`repro_torch.analysis.staticcheck`)."""
