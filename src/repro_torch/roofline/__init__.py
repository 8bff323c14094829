"""Roofline arithmetic (counterpart of ``repro/roofline``).  Only the
context-parallel attention's wire model is ported so far; the HLO-based
roofline and its report are ROADMAP.md, A6.5."""
