"""General drivers: each serves every traffic mix that names it.

A driver module exposes ``Cell(config, traffic, seed, device, limits)``
with ``setup()``, ``window(seconds)``, ``traced()``, ``context()``,
``release()``, ``check(reference)`` and the counts ``attempted`` and
``failed``; ``run.py`` calls them in that order.
"""
