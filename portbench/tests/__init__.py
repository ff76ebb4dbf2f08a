"""CPU tests of the benchmark; the ``gpu``-marked ones need a card."""
