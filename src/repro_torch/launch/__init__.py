"""Entry points: step functions (``steps``) and the serve CLI
(``serve``)."""
