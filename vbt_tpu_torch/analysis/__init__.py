"""Rep analysis: phase segmentation, ROM and ACV, on the host (numpy
float64, :mod:`velocity`) or with torch on a named device
(:mod:`velocity_torch`)."""
