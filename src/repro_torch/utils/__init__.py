"""Host-side helpers of the port (``roofline``: the H100's published roofs)."""
