"""Frozen copies of the port's host-side layout code (``circuit/ir.py``,
``models/aes128.py``, ``chips.py``, ``constants.py``,
``key_schedule.py``, ``table.py``) and of its protocol definition
(``backend/protocol.py``), with their imports pointed here, so that the
reference shares no code with the program it judges.  The CPU tests
hold the layout they compile against the port's."""
