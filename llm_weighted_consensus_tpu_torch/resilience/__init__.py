"""Overload and device-health guards of the port's serving path:
per-request deadlines (``deadline``), admission control at the gateway
(``admission``) and the device dispatch watchdog (``watchdog``)."""
