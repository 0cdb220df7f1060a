"""Host utilities: the Zipfian generator the chaos traffic shapes use."""
