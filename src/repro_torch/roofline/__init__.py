"""The roofline of one rank's program, traced on the ``meta`` device
(:mod:`repro_torch.roofline.analysis`), and the tables of the dry-run's
cells (:mod:`repro_torch.roofline.report`)."""
