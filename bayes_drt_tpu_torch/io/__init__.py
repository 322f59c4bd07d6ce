from .file_load import (construct_eis_df, get_file_source, get_fZ,
                        get_timestamp, load_eis_dir, read_eis, read_gen_curve,
                        read_jv, read_lsv, read_ocv, source_extension)

__all__ = ["construct_eis_df", "get_file_source", "get_fZ", "get_timestamp",
           "load_eis_dir", "read_eis", "read_gen_curve", "read_jv", "read_lsv",
           "read_ocv", "source_extension"]
