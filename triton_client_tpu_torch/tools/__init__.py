"""Operators' tools of the port, run as ``python -m
triton_client_tpu_torch.tools.<name>``.  Standard library only: a tool
runs wherever its input was copied to, without PyTorch.

``incident_report`` renders an incident bundle (``server/incident.py``)
as a postmortem.
"""
