"""``repro_torch.roofline`` — the roofline report type and the measured
utilizations of dry-run artifacts (counterpart of
``repro.roofline.analysis``; the HLO parsing has no PyTorch counterpart and
stays unported)."""
