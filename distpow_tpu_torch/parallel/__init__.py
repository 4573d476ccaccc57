"""Partition algebra and the search driver.

Import the driver as ``from distpow_tpu_torch.parallel.search import
search``; this package exposes no attribute that shadows the submodule.
"""
