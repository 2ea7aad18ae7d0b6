"""Losses of the port: CE, OHEM and aux CE, the plain seg losses and the
contrast + CE loss with or without the memory bank."""
