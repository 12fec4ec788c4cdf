"""device.launches.host_paced: ``device.launches``'s reading in the cells
whose rate the host's issue of the steps sets (they spread more from run
to run, so their end-to-end metrics have bounds of their own)."""

from phdbench.harness import load_reader

read = load_reader("device.launches")
