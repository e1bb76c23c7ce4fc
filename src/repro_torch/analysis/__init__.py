"""The port's diagnostics vocabulary (``diagnostics``)."""
