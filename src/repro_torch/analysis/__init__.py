"""The dry-run's analysis (port of ``repro.analysis``): the collectives a
traced step dispatches, priced by the ring model (``collectives``), and the
three-term roofline on the H100 (``roofline``)."""
