"""Published peaks of the card (NVIDIA H100 SXM data sheet, at its 700 W
limit): HBM3 bandwidth, the roof of a memory-bound kernel."""

H100_SXM = {"hbm_bytes_per_s": 3.35e12}
