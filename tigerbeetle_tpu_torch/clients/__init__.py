"""Client helpers: the typed request encoding every client shares
(common.py). The port's client is the pure-Python `vsr.client.Client`."""
