"""Host-side helpers of the port: ``roofline`` (the H100's published roofs
and the dry run's ``Roofline``), ``collectives`` (a dry rank's wire bytes)
and ``opprof`` (a profile's time by op)."""
