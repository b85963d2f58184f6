"""The plain references: ``<config>.py`` what a configuration's kinds of
cell share, ``<config>.<window>.py`` each kind's. They import nothing of
the port: ``frozen/`` holds copies of its plain code."""
