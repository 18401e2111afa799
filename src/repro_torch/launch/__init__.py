"""Launchers: the training launcher (``train``), the serving launcher
(``serve``) and the step functions they drive (``steps``)."""
