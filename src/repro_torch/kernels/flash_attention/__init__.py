"""Flash attention: K6 (Hopper kernel), its plain torch version and the
device dispatcher."""
