"""Applications (counterpart of ``repro.apps``)."""
