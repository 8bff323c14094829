"""Roofline arithmetic (counterpart of ``repro/roofline``): a recorded step
in place of compiled HLO (``record``), its roofline terms, collective wire
bytes and dot FLOPs (``analysis``, with the analytic CP wire model), and
the dry-run tables (``report``)."""
