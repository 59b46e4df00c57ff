"""The constants of ``repro/configs/registry.py`` that the ported configs
need.  ``registry``, ``ArchSpec`` and the ``*_SHAPES`` cells are not
ported yet (ROADMAP Queue 1 item 3)."""

# MLPerf DLRM (Criteo 1TB, uncapped) per-feature embedding rows.
CRITEO_ROWS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63,
    38532951, 2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14,
    39979771, 25641295, 39664984, 585935, 12972, 108, 36,
)
