"""Operators' tools of the port, run as ``python -m
triton_client_tpu_torch.tools.<name>`` (the port has no console scripts).
Standard library only: a tool runs wherever its input was copied to, or
wherever the server it polls is reachable from, without PyTorch or numpy
(``tests/test_torch_tools_import.py``).

``trace_summary`` reads the server's trace files: per-model and per-stage
latency breakdowns, the join with the clients' trace files on
``triton-request-id`` and their journeys, and a Chrome trace-event export
for Perfetto.

``top`` is the live console: it polls a running server's ``/metrics`` and
``/v2/debug/flight_recorder`` and renders a refreshing per-model table,
one aggregated row per model over several ``--url``, with ``--once
--json`` for scripting.

``incident_report`` renders an incident bundle (``server/incident.py``)
as a postmortem.
"""
