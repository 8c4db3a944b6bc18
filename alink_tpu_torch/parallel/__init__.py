"""Distributed substrate of the port: the APS embedding tables and their
hot-key cache. The reference's device mesh becomes the world of ranks,
of size 1 on one card."""
