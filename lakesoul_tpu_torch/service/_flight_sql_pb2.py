# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: flight_sql.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10\x66light_sql.proto\x12\x19\x61rrow.flight.protocol.sql\"V\n\x15\x43ommandStatementQuery\x12\r\n\x05query\x18\x01 \x01(\t\x12\x1b\n\x0etransaction_id\x18\x02 \x01(\x0cH\x00\x88\x01\x01\x42\x11\n\x0f_transaction_id\"0\n\x14TicketStatementQuery\x12\x18\n\x10statement_handle\x18\x01 \x01(\x0c\"W\n\x16\x43ommandStatementUpdate\x12\r\n\x05query\x18\x01 \x01(\t\x12\x1b\n\x0etransaction_id\x18\x02 \x01(\x0cH\x00\x88\x01\x01\x42\x11\n\x0f_transaction_id\")\n\x11\x44oPutUpdateResult\x12\x14\n\x0crecord_count\x18\x01 \x01(\x03\"e\n$ActionCreatePreparedStatementRequest\x12\r\n\x05query\x18\x01 \x01(\t\x12\x1b\n\x0etransaction_id\x18\x02 \x01(\x0cH\x00\x88\x01\x01\x42\x11\n\x0f_transaction_id\"z\n#ActionCreatePreparedStatementResult\x12!\n\x19prepared_statement_handle\x18\x01 \x01(\x0c\x12\x16\n\x0e\x64\x61taset_schema\x18\x02 \x01(\x0c\x12\x18\n\x10parameter_schema\x18\x03 \x01(\x0c\"H\n#ActionClosePreparedStatementRequest\x12!\n\x19prepared_statement_handle\x18\x01 \x01(\x0c\"B\n\x1d\x43ommandPreparedStatementQuery\x12!\n\x19prepared_statement_handle\x18\x01 \x01(\x0c\"C\n\x1e\x43ommandPreparedStatementUpdate\x12!\n\x19prepared_statement_handle\x18\x01 \x01(\x0c\"\x1f\n\x1d\x41\x63tionBeginTransactionRequest\"6\n\x1c\x41\x63tionBeginTransactionResult\x12\x16\n\x0etransaction_id\x18\x01 \x01(\x0c\"\xf9\x01\n\x1b\x41\x63tionEndTransactionRequest\x12\x16\n\x0etransaction_id\x18\x01 \x01(\x0c\x12U\n\x06\x61\x63tion\x18\x02 \x01(\x0e\x32\x45.arrow.flight.protocol.sql.ActionEndTransactionRequest.EndTransaction\"k\n\x0e\x45ndTransaction\x12\x1f\n\x1b\x45ND_TRANSACTION_UNSPECIFIED\x10\x00\x12\x1a\n\x16\x45ND_TRANSACTION_COMMIT\x10\x01\x12\x1c\n\x18\x45ND_TRANSACTION_ROLLBACK\x10\x02\"\xb6\x07\n\x16\x43ommandStatementIngest\x12j\n\x18table_definition_options\x18\x01 \x01(\x0b\x32H.arrow.flight.protocol.sql.CommandStatementIngest.TableDefinitionOptions\x12\r\n\x05table\x18\x02 \x01(\t\x12\x13\n\x06schema\x18\x03 \x01(\tH\x00\x88\x01\x01\x12\x14\n\x07\x63\x61talog\x18\x04 \x01(\tH\x01\x88\x01\x01\x12\x11\n\ttemporary\x18\x05 \x01(\x08\x12\x1b\n\x0etransaction_id\x18\x06 \x01(\x0cH\x02\x88\x01\x01\x12P\n\x07options\x18\xe8\x07 \x03(\x0b\x32>.arrow.flight.protocol.sql.CommandStatementIngest.OptionsEntry\x1a\x99\x04\n\x16TableDefinitionOptions\x12r\n\x0cif_not_exist\x18\x01 \x01(\x0e\x32\\.arrow.flight.protocol.sql.CommandStatementIngest.TableDefinitionOptions.TableNotExistOption\x12m\n\tif_exists\x18\x02 \x01(\x0e\x32Z.arrow.flight.protocol.sql.CommandStatementIngest.TableDefinitionOptions.TableExistsOption\"\x81\x01\n\x13TableNotExistOption\x12&\n\"TABLE_NOT_EXIST_OPTION_UNSPECIFIED\x10\x00\x12!\n\x1dTABLE_NOT_EXIST_OPTION_CREATE\x10\x01\x12\x1f\n\x1bTABLE_NOT_EXIST_OPTION_FAIL\x10\x02\"\x97\x01\n\x11TableExistsOption\x12#\n\x1fTABLE_EXISTS_OPTION_UNSPECIFIED\x10\x00\x12\x1c\n\x18TABLE_EXISTS_OPTION_FAIL\x10\x01\x12\x1e\n\x1aTABLE_EXISTS_OPTION_APPEND\x10\x02\x12\x1f\n\x1bTABLE_EXISTS_OPTION_REPLACE\x10\x03\x1a.\n\x0cOptionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x42\t\n\x07_schemaB\n\n\x08_catalogB\x11\n\x0f_transaction_id\"\x14\n\x12\x43ommandGetCatalogs\"{\n\x13\x43ommandGetDbSchemas\x12\x14\n\x07\x63\x61talog\x18\x01 \x01(\tH\x00\x88\x01\x01\x12%\n\x18\x64\x62_schema_filter_pattern\x18\x02 \x01(\tH\x01\x88\x01\x01\x42\n\n\x08_catalogB\x1b\n\x19_db_schema_filter_pattern\"\xeb\x01\n\x10\x43ommandGetTables\x12\x14\n\x07\x63\x61talog\x18\x01 \x01(\tH\x00\x88\x01\x01\x12%\n\x18\x64\x62_schema_filter_pattern\x18\x02 \x01(\tH\x01\x88\x01\x01\x12&\n\x19table_name_filter_pattern\x18\x03 \x01(\tH\x02\x88\x01\x01\x12\x13\n\x0btable_types\x18\x04 \x03(\t\x12\x16\n\x0einclude_schema\x18\x05 \x01(\x08\x42\n\n\x08_catalogB\x1b\n\x19_db_schema_filter_patternB\x1c\n\x1a_table_name_filter_pattern\"\x16\n\x14\x43ommandGetTableTypes\"n\n\x15\x43ommandGetPrimaryKeys\x12\x14\n\x07\x63\x61talog\x18\x01 \x01(\tH\x00\x88\x01\x01\x12\x16\n\tdb_schema\x18\x02 \x01(\tH\x01\x88\x01\x01\x12\r\n\x05table\x18\x03 \x01(\tB\n\n\x08_catalogB\x0c\n\n_db_schema\"!\n\x11\x43ommandGetSqlInfo\x12\x0c\n\x04info\x18\x01 \x03(\rb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'flight_sql_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _COMMANDSTATEMENTINGEST_OPTIONSENTRY._options = None
  _COMMANDSTATEMENTINGEST_OPTIONSENTRY._serialized_options = b'8\001'
  _COMMANDSTATEMENTQUERY._serialized_start=47
  _COMMANDSTATEMENTQUERY._serialized_end=133
  _TICKETSTATEMENTQUERY._serialized_start=135
  _TICKETSTATEMENTQUERY._serialized_end=183
  _COMMANDSTATEMENTUPDATE._serialized_start=185
  _COMMANDSTATEMENTUPDATE._serialized_end=272
  _DOPUTUPDATERESULT._serialized_start=274
  _DOPUTUPDATERESULT._serialized_end=315
  _ACTIONCREATEPREPAREDSTATEMENTREQUEST._serialized_start=317
  _ACTIONCREATEPREPAREDSTATEMENTREQUEST._serialized_end=418
  _ACTIONCREATEPREPAREDSTATEMENTRESULT._serialized_start=420
  _ACTIONCREATEPREPAREDSTATEMENTRESULT._serialized_end=542
  _ACTIONCLOSEPREPAREDSTATEMENTREQUEST._serialized_start=544
  _ACTIONCLOSEPREPAREDSTATEMENTREQUEST._serialized_end=616
  _COMMANDPREPAREDSTATEMENTQUERY._serialized_start=618
  _COMMANDPREPAREDSTATEMENTQUERY._serialized_end=684
  _COMMANDPREPAREDSTATEMENTUPDATE._serialized_start=686
  _COMMANDPREPAREDSTATEMENTUPDATE._serialized_end=753
  _ACTIONBEGINTRANSACTIONREQUEST._serialized_start=755
  _ACTIONBEGINTRANSACTIONREQUEST._serialized_end=786
  _ACTIONBEGINTRANSACTIONRESULT._serialized_start=788
  _ACTIONBEGINTRANSACTIONRESULT._serialized_end=842
  _ACTIONENDTRANSACTIONREQUEST._serialized_start=845
  _ACTIONENDTRANSACTIONREQUEST._serialized_end=1094
  _ACTIONENDTRANSACTIONREQUEST_ENDTRANSACTION._serialized_start=987
  _ACTIONENDTRANSACTIONREQUEST_ENDTRANSACTION._serialized_end=1094
  _COMMANDSTATEMENTINGEST._serialized_start=1097
  _COMMANDSTATEMENTINGEST._serialized_end=2047
  _COMMANDSTATEMENTINGEST_TABLEDEFINITIONOPTIONS._serialized_start=1420
  _COMMANDSTATEMENTINGEST_TABLEDEFINITIONOPTIONS._serialized_end=1957
  _COMMANDSTATEMENTINGEST_TABLEDEFINITIONOPTIONS_TABLENOTEXISTOPTION._serialized_start=1674
  _COMMANDSTATEMENTINGEST_TABLEDEFINITIONOPTIONS_TABLENOTEXISTOPTION._serialized_end=1803
  _COMMANDSTATEMENTINGEST_TABLEDEFINITIONOPTIONS_TABLEEXISTSOPTION._serialized_start=1806
  _COMMANDSTATEMENTINGEST_TABLEDEFINITIONOPTIONS_TABLEEXISTSOPTION._serialized_end=1957
  _COMMANDSTATEMENTINGEST_OPTIONSENTRY._serialized_start=1959
  _COMMANDSTATEMENTINGEST_OPTIONSENTRY._serialized_end=2005
  _COMMANDGETCATALOGS._serialized_start=2049
  _COMMANDGETCATALOGS._serialized_end=2069
  _COMMANDGETDBSCHEMAS._serialized_start=2071
  _COMMANDGETDBSCHEMAS._serialized_end=2194
  _COMMANDGETTABLES._serialized_start=2197
  _COMMANDGETTABLES._serialized_end=2432
  _COMMANDGETTABLETYPES._serialized_start=2434
  _COMMANDGETTABLETYPES._serialized_end=2456
  _COMMANDGETPRIMARYKEYS._serialized_start=2458
  _COMMANDGETPRIMARYKEYS._serialized_end=2568
  _COMMANDGETSQLINFO._serialized_start=2570
  _COMMANDGETSQLINFO._serialized_end=2603
# @@protoc_insertion_point(module_scope)
