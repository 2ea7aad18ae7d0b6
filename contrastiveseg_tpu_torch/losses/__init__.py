"""Losses of the port: CE, OHEM and aux CE, the plain seg losses, the
contrast + CE loss with or without the memory bank, RMI, Lovasz and
SegFix's offset loss."""
