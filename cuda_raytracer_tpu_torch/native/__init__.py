"""Native (C++) host components, compiled at first use and bound with ctypes."""
