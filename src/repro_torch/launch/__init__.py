"""Launchers: the serving launcher (``serve``) and the step functions it
drives (``steps``)."""
