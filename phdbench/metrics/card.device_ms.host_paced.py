"""card.device_ms.host_paced: ``card.device_ms``'s reading in the cells
whose rate the host sets by the pace at which it launches the steps (they
spread more from run to run, so their end-to-end metrics have bounds of
their own)."""

from phdbench.harness import load_reader

read = load_reader("card.device_ms")
