"""The REST surface (counterpart of ``cruise_control_tpu/api/``): only
``responses.py``'s operation-result renderers are ported; the server and the
other renderers are ROADMAP Queue 1 item 12."""
