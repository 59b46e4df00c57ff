"""CPU tests of the benchmark (a few seconds in all); the ``cuda`` ones
run on a card and skip elsewhere."""
