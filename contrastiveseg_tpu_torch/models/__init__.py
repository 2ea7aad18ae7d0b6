"""Models of the port: the HRNet backbone, its heads and ``HRNetSeg``
(plain, contrast and mem)."""
