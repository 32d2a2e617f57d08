"""SGF parsing and serialization."""
from p3achygo_tpu_torch.sgf.sgf import (  # noqa: F401
    SgfNode,
    extract_moves,
    game_info,
    loc_to_sgf,
    main_line,
    parse_sgf,
    result_string,
    serialize_game,
    serialize_game_with_tree,
    sgf_to_loc,
)
