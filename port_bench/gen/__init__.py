"""Traffic generators: ``gen/<name>.py`` has ``generate(traffic, seed)``,
named by a traffic file's ``"generator"``."""
