"""The YOHO session's training stages (``run-session <name> <stage>``)."""
