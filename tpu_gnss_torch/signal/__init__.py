"""Scene synthesis for tests and the chip smoke run."""
