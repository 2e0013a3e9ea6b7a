"""The traffic kinds, one file a kind: a traffic file's ``"kind": "<kind>"``
is ``kinds/<kind>.py``, whose ``Driver`` subclasses ``drivers.Driver`` and
keeps its contract: ``setup()``, ``window(seconds, win)`` returning the cell's
end-to-end values and ``attempted``, ``free()``, ``check(control)`` returning
the numbers compared with the reference, and the counts in ``work`` that the
per-layer readers take. ``self.mm`` is the configuration's model module
(``models/``). A new kind is a new file here."""
