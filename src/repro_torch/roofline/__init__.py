"""``repro_torch.roofline`` — the roofline report type (counterpart of the
``RooflineReport`` part of ``repro.roofline.analysis``; the HLO parsing
has no PyTorch counterpart and stays unported)."""
