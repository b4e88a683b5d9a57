"""CPU tests of the benchmark; the card tests carry the `gpu` marker."""
