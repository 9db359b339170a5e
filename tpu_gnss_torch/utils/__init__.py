"""Stage timers."""
