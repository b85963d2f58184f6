"""One module per kind of cell, named by a traffic mix's ``window``: each
has ``run`` (drive the port's entry points, return what the metrics and
the check read, with the end-to-end metrics under ``e2e``) and ``check``
(the reference, then the numbers compared)."""
