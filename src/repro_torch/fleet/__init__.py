"""The port's copies of the fleet simulator's arrival pieces, which the
serve CLI's ``--span/--arrival`` draws on (``workload.make_warp``,
``scenarios.ArrivalModulation``, ``scenarios.SCENARIOS`` and
``scenarios.request_arrivals``).  Nothing else of ``repro.fleet`` is
ported: the simulator has no device code."""
