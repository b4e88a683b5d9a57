"""Traffic drivers: each runs one kind of traffic mix against the
program (``setup``, ``window``, ``release``, ``check``); a mix names its
driver in its ``driver`` key."""
