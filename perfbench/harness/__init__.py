"""The benchmark's own code: the yardstick that later changes to the
program are measured against. Of it only ``program.py`` imports the
program; the reference imports nothing of it."""
