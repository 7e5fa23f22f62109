"""Model specifications (the port's copies of ``repro.models``)."""
